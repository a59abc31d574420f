"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py [--seed 0]

Builds every CUDA kernel of the serving path from ``src/repro_torch``,
holds each kernel against its plain PyTorch version at the path's shapes,
serves qwen1.5-0.5b at full width (bf16, 24 layers, random weights from
``--seed``) with 8 heterogeneous adapters through ``SlotServer`` and
``generate``, checks that every projection went through the kernel,
compares one prefill + 4 decode steps against the plain version end to
end, and times each kernel against its bound. Every phase prints JSON
lines; any failure raises and the script exits non-zero without the
closing ``{"ok": true, ...}`` line. Needs one CUDA card; imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, FP32 (non-tensor)
# rate, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

B, G, R = 8, 8, 16                     # decode batch, adapters, rank
PROMPT, NEW = 128, 32
SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]   # (m, n) of the path
# one qwen1.5-0.5b layer: wq wk wv wo @ (1024,1024), w_gate w_up @
# (1024,2816), w_down @ (2816,1024)
LAYER_MIX = {(1024, 1024): 4, (1024, 2816): 2, (2816, 1024): 1}
PARITY_BOUND = 5e-2     # max |logit diff| / max |logit|, bf16 end to end


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------- build --

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USE = re.compile(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")


def ptxas_summary(log: str):
    """Per entry function: registers, static shared memory, spills."""
    out, cur = [], None
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            name = m.group(1)
            short = re.search(r"(shrink_kernel|gemm_kernel|"
                              r"reduce_epilogue_kernel)I(.*?)EEv", name)
            cur = {"function": (short.group(1) + "<" + short.group(2) + ">")
                   if short else name}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_USE.search(line.strip())
        if m:
            cur.update(registers=int(m.group(1)),
                       smem=int(m.group(2) or 0))
    return out


# ------------------------------------------------------------ kernel data --

def make_case(gen, m, n, t, dtype, ids, two_d=False, dev="cuda"):
    side = "right" if m >= n else "left"
    bdim = n if side == "right" else m
    b = len(ids)
    x = torch.randn((b, m) if two_d else (b, t, m), generator=gen,
                    device=dev).to(dtype)
    w = (torch.randn(m, n, generator=gen, device=dev) / m ** 0.5).to(dtype)
    bases = torch.randn(G, bdim, R, generator=gen, device=dev) / bdim ** 0.5
    rts = 0.02 * torch.randn(*((G, m, R) if side == "right" else (G, R, n)),
                             generator=gen, device=dev)
    scales = 1.0 + 0.1 * torch.randn(G, generator=gen, device=dev)
    return dict(x=x, w=w, bases=bases, rts=rts, scales=scales,
                ids=torch.as_tensor(ids, dtype=torch.int32, device=dev),
                side=side)


def case_key(x, w):
    """(B, t, m, n, x dims, dtype) of one kernel call."""
    return (x.shape[0], x.shape[1] if x.ndim == 3 else 1, *w.shape, x.ndim,
            str(x.dtype).split(".")[1])


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def bound(case):
    """(ms, 'bytes'|'operations'): each input read once (tables: only the
    adapters this batch selects), the output written once; the base GEMM at
    its operands' peak, the rank-r shrink/expand on fp32 tables at FP32."""
    x, w, ids = case["x"], case["w"], case["ids"]
    m, n = w.shape
    rows = x.numel() // m
    used = len(set(ids.tolist()))
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + used * (case["bases"][0].numel() + case["rts"][0].numel()
                        + 1) * 4 + ids.numel() * 4
              + rows * n * torch.result_type(x, w).itemsize)
    peak = PEAK_BF16 if x.dtype == w.dtype == torch.bfloat16 else PEAK_FP32
    ops_s = 2.0 * rows * m * n / peak + 2.0 * rows * R * (m + n) / PEAK_FP32
    bytes_s = nbytes / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def time_ms(fn, sets, warmup=5, iters=40):
    """Mean ms per call with CUDA events; ``sets`` rotate so the working
    set exceeds the 50 MB L2, as in a real forward where each layer's
    weights arrive cold."""
    for i in range(warmup):
        fn(sets[i % len(sets)])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, sets, calls=20, replays=5):
    """Mean device ms per call with the host out of the way: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in sets[:3]:
            fn(c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------- phases --

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    for src in sorted(_build.CSRC.glob("*.cu")):
        _build.build(src.stem)
        emit({"phase": "build", "kernel": src.stem,
              "seconds": time.perf_counter() - t0,
              "ptxas": ptxas_summary(_build.PTXAS_LOG.get(src.stem, ""))})


def phase_kernel_checks(gen):
    """The kernel against the plain version at the path's shapes: decode
    (B, 1) of SlotServer and generate, prefill (B, PROMPT) of generate and
    (1, PROMPT) of SlotServer's per-request admission, ragged tails, fp32
    and 2-D x. Returns the worst error and the keys checked."""
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels.ref import lowrank_linear_batched_ref
    ids = [0, 3, 3, 7, 1, 0, 5, 2]          # duplicates, not every adapter
    cases = [(b, m, n, t, torch.bfloat16, False) for (m, n) in SHAPES
             for b, t in ((B, 1), (B, 100), (B, PROMPT), (1, PROMPT),
                          (1, 100))]
    cases += [(B, 1024, 2816, 100, torch.float32, False),
              (B, 2816, 1024, 1, torch.bfloat16, True)]     # 2-D x
    worst, checked = 0.0, set()
    for b, m, n, t, dtype, two_d in cases:
        c = make_case(gen, m, n, t, dtype, ids[-b:], two_d)
        args = (c["x"], c["w"], c["bases"], c["rts"], c["scales"], c["ids"])
        y = ll.lowrank_linear_batched(*args, side=c["side"])
        torch.cuda.synchronize()
        want = lowrank_linear_batched_ref(*args, side=c["side"])
        check(y.dtype == want.dtype and y.shape == want.shape,
              f"kernel output {y.dtype}{tuple(y.shape)} vs plain "
              f"{want.dtype}{tuple(want.shape)}")
        err = (y.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2 * bf16_ulp(scale)
        emit({"phase": "kernel_check", "B": b, "m": m, "n": n, "t": t,
              "x_dims": c["x"].ndim, "dtype": str(dtype).split(".")[1],
              "side": c["side"], "max_abs_err": err, "out_scale": scale,
              "tol": tol})
        check(err <= tol, f"kernel disagrees with plain at B={b} m={m} n={n} "
                          f"t={t} {dtype}: {err} > {tol}")
        worst = max(worst, err)
        checked.add(case_key(c["x"], c["w"]))
    return worst, checked


class ShapeLog:
    """Records the (B, t, m, n, dims, dtype) of every kernel call made
    inside the context. ``kernels.ops`` reaches the wrapper through its
    module reference ``_ll``; that reference alone is swapped, so the
    wrapper and its launch counter stay as they are."""

    def __enter__(self):
        from types import SimpleNamespace
        from repro_torch.kernels import ops
        self.ops, self.orig, self.seen = ops, ops._ll, set()

        def logged(x, w, *args, **kw):
            self.seen.add(case_key(x, w))
            return self.orig.lowrank_linear_batched(x, w, *args, **kw)

        ops._ll = SimpleNamespace(infer_side=self.orig.infer_side,
                                  lowrank_linear_batched=logged)
        return self

    def __exit__(self, *exc):
        self.ops._ll = self.orig
        return False


def phase_serve(seed, card, checked):
    """The port's main path at full width: SlotServer serves 16 requests,
    then generate runs once; every projection goes through the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.launch import adapters as adapters_lib
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib

    cfg = get_config("qwen1.5-0.5b")
    check(cfg.param_dtype == torch.bfloat16 and cfg.n_layers == 24,
          "qwen1.5-0.5b config is not the full-width bf16 one")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=seed, device="cuda")
    served = adapters_lib.demo_wrap(params, cfg, G, rank=R, seed=seed + 2)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_forward = 7 * cfg.n_layers
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, cfg.vocab_size, (2 * B, PROMPT), dtype=np.int32)
    reqs = [serve.Request(rid=i, prompt=prompts[i], max_new=NEW,
                          adapter=i % G) for i in range(2 * B)]
    # warm-up (CUDA context, library handles), outside the counted run
    serve.SlotServer(served, cfg, slots=B, cache_len=PROMPT + NEW).run(
        [serve.Request(rid=0, prompt=prompts[0], max_new=2)])

    ll.lowrank_linear_batched.launches = 0
    with ShapeLog() as log:
        srv = serve.SlotServer(served, cfg, slots=B, cache_len=PROMPT + NEW,
                               segment=8)
        out = srv.run(reqs)
        gen_out = serve.generate(served, cfg, prompts[:B], NEW, PROMPT + NEW,
                                 adapters=np.arange(B) % G)
        torch.cuda.synchronize()
    launches = ll.lowrank_linear_batched.launches
    check(log.seen <= checked, "the main path launched the kernel at shapes "
          f"the kernel checks did not cover: {sorted(log.seen - checked)}")

    s = out["stats"]
    forwards = (s["admitted"] + s["segments"] * srv.segment   # SlotServer
                + 1 + (NEW - 1))                               # generate
    check(launches == per_forward * forwards,
          f"kernel launches {launches} != {per_forward} x {forwards} "
          "forwards: a projection bypassed the kernel")
    check(s["admitted"] == 2 * B and not srv.active.any(),
          "SlotServer did not serve every request")
    for i in range(2 * B):
        toks = out["outputs"][i]
        check(len(toks) == NEW and all(0 <= v < cfg.vocab_size
                                       for v in toks),
              f"request {i}: {len(toks)} tokens, out of range or short")
    check(tuple(gen_out.shape) == (B, PROMPT + NEW) and
          bool(((gen_out >= 0) & (gen_out < cfg.vocab_size)).all()),
          "generate output has the wrong shape or range")
    emit({"phase": "serve", "arch": cfg.name, "card": card,
          "requests": 2 * B, "slots": B, "prompt": PROMPT, "max_new": NEW,
          "adapters": G, "rank": R, "setup_s": setup_s,
          "prefill_tok_s": s["prefill_tok_s"],
          "decode_tok_s": s["decode_tok_s"], "segments": s["segments"],
          "forwards": forwards, "launches": launches,
          "launches_per_forward": per_forward,
          "kernel_shapes": sorted(log.seen)})
    return cfg, served, launches


def phase_parity(cfg, served, seed):
    """One prefill + 4 decode steps, kernel vs plain version on the card,
    the same tokens fed to both."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    rng = np.random.default_rng(seed + 3)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, PROMPT),
                                           dtype=np.int32), device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, B),
                                        dtype=np.int32), device="cuda")
    ids = torch.arange(B, dtype=torch.int32, device="cuda") % G

    @torch.inference_mode()
    def run():
        st = model_lib.init_decode_state(cfg, B, PROMPT + 4, device="cuda")
        outs = []
        with layers.adapter_ids(ids):
            logits, st = model_lib.prefill(served, cfg, prompts, st)
            outs.append(logits)
            for i in range(4):
                logits, st = model_lib.decode_step(served, cfg, feed[i], st)
                outs.append(logits)
        return torch.stack(outs)

    got = run()
    with ops.lowrank_kernel_override():
        want = run()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel-path logits not finite")
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    emit({"phase": "parity", "forwards": "prefill + 4 decode", "batch": B,
          "logit_scale": scale, "max_abs_diff_rel": rel,
          "greedy_agreement": agree, "bound": PARITY_BOUND})
    check(rel <= PARITY_BOUND, f"end-to-end logits differ by {rel} of the "
                               f"logit scale > {PARITY_BOUND}")


def phase_times(gen, card):
    """Kernel, plain version and torch.matmul of the base product alone at
    decode (B=8, t=1) and prefill (B=8, t=128) for each projection shape."""
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels.ref import lowrank_linear_batched_ref
    ids = list(range(B))
    rows = []
    for m, n in SHAPES:
        for label, t in (("decode", 1), ("prefill", PROMPT)):
            per = 2 * (m * n + B * t * (m + n)) + G * R * (m + n) * 4
            sets = [make_case(gen, m, n, t, torch.bfloat16, ids)
                    for _ in range(max(2, -(-150_000_000 // per)))]

            def kern(c):
                return ll.lowrank_linear_batched(
                    c["x"], c["w"], c["bases"], c["rts"], c["scales"],
                    c["ids"], side=c["side"])

            def plain(c):
                return lowrank_linear_batched_ref(
                    c["x"], c["w"], c["bases"], c["rts"], c["scales"],
                    c["ids"], side=c["side"])

            def library(c):
                return torch.matmul(c["x"], c["w"])

            b_ms, b_by = bound(sets[0])
            row = {"phase": "times", "card": card, "m": m, "n": n,
                   "shape": label, "B": B, "t": t,
                   "library": "torch.matmul(x, W), base product only",
                   "bound_ms": b_ms, "bound_by": b_by}
            for key, fn in (("ms", kern), ("plain_ms", plain),
                            ("library_ms", library)):
                row[key] = time_ms(fn, sets)
                row["device_" + key] = graph_ms(fn, sets)
            row["bound_share"] = b_ms / row["ms"]
            row["device_bound_share"] = b_ms / row["device_ms"]
            emit(row)
            rows.append(row)
            del sets
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    max_err, checked = phase_kernel_checks(gen)
    cfg, served, launches = phase_serve(args.seed, card, checked)
    phase_parity(cfg, served, args.seed)
    del served
    torch.cuda.empty_cache()
    rows = phase_times(gen, card)

    decode = [r for r in rows if r["shape"] == "decode"]
    per_layer = {k: sum(LAYER_MIX[(r["m"], r["n"])] * r[k] for r in decode)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "device_ms", "device_plain_ms",
                           "device_library_ms")}
    emit({"kernels": [{
        "name": "lowrank_linear_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_linear_batched.cu",
        "replaces": "src/repro/kernels/lowrank_linear.py:140",
        "launches": launches, "max_abs_err": max_err,
        "ms": per_layer["ms"], "plain_ms": per_layer["plain_ms"],
        "bound_ms": per_layer["bound_ms"], "bound_by": "bytes"
        if all(r["bound_by"] == "bytes" for r in decode) else "operations",
        "library_ms": per_layer["library_ms"],
        "device_ms": per_layer["device_ms"],
        "device_plain_ms": per_layer["device_plain_ms"],
        "device_library_ms": per_layer["device_library_ms"],
        "at": "one qwen1.5-0.5b layer of one decode step: 4x(1024x1024) + "
              "2x(1024x2816) + 1x(2816x1024), B=8, t=1, G=8, r=16, bf16; "
              "ms: CUDA events over back-to-back eager calls (host "
              "overhead included); device_ms: the same calls replayed "
              "from a CUDA graph; library_ms is torch.matmul of the base "
              "products alone",
        "card": card}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
