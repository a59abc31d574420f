"""Where the qwen runtime rounds' kernel-against-plain readings come from,
on one CUDA card.

  python3 scripts/runtime_floor.py [--seed 0]

Three parts, each one JSON line:

1. ``lowrank_linear`` at the training path's shapes (x (4, 128, m) bf16,
   rank 8, rt of scale 0, 1e-3 and 3e-2): the kernel's, the plain
   version's and cuBLAS's bf16 GEMM's outputs against the float64 answer
   in units in the last place (mean, rms, the share more than half an ulp
   off) and the share of outputs where the kernel and the plain version
   differ.
2. ``chip_smoke.py``'s ``train_runtime`` traffic (qwen1.5-0.5b at full
   width, C = 4, T = 2, batch 4 x 128, rank 8, lr 3e-3) for the two
   ``run_round`` rounds with the kernels, with every plain version, with
   only ``lowrank_linear`` on its kernel and with only ``jacobi_eigh``
   on its kernel: which kernel moves the losses and D.
3. The same rounds with ``lowrank_linear`` computed in float64 and
   rounded once (the exact apply): the kernel's and the plain version's
   distance from it.
4. The planted fault of ``train_runtime`` (each basis rolled by one
   column into ``lowrank_linear``) at lr 3e-3, and at ``RWKV_LR`` (3e-4)
   the kernels, two embedding-ulp and two rounding-noise controls and the
   fault, each against the plain run at that rate: how far a fault and
   the floor read at each rate.

``--parts`` picks the parts to run (default all: ``1,2,3,4``).

Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def apply_rounding(seed):
    """Part 1: the three applies' outputs against float64, in ulps."""
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = []
    for m, n in ((1024, 1024), (1024, 2816), (2816, 1024)):
        side = "right" if m >= n else "left"
        for rt_scale in (0.0, 1e-3, 3e-2):
            x = torch.randn(4, 128, m, generator=gen,
                            device="cuda").to(torch.bfloat16)
            w = (0.02 * torch.randn(m, n, generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            basis = torch.linalg.qr(torch.randn(
                n if side == "right" else m, 8, generator=gen,
                device="cuda"))[0].contiguous()
            rt = rt_scale * torch.randn(
                *((m, 8) if side == "right" else (8, n)), generator=gen,
                device="cuda")
            scale = torch.tensor(0.99997, device="cuda")
            delta = ((x.float() @ rt) @ basis.mT if side == "right"
                     else (x.float() @ basis) @ rt)
            outs = {"kernel": ll.lowrank_linear(x, w, basis, rt, scale,
                                                side=side),
                    "plain": ref.lowrank_linear_ref(x, w, basis, rt, scale,
                                                    side=side),
                    "cublas_bf16": (scale * torch.matmul(x, w).float()
                                    + delta).to(torch.bfloat16)}
            xd = x.double()
            d64 = ((xd @ rt.double()) @ basis.double().mT if side == "right"
                   else (xd @ basis.double()) @ rt.double())
            y64 = scale.double() * (xd @ w.double()) + d64
            ulp = torch.pow(2.0, torch.floor(torch.log2(
                torch.clamp(y64.abs(), min=1e-30))) - 7)
            row = {"m": m, "n": n, "rt_scale": rt_scale,
                   "kernel_differs_from_plain": (
                       outs["kernel"] != outs["plain"]).float().mean().item()}
            for name, y in outs.items():
                e = (y.double() - y64) / ulp
                row[name] = {"mean_ulp": e.mean().item(),
                             "rms_ulp": e.pow(2).mean().sqrt().item(),
                             "over_half_ulp": (e.abs() > 0.5001).float()
                             .mean().item()}
            rows.append(row)
    return rows


@contextlib.contextmanager
def only_kernel(name):
    """Every kernel of the round but ``name`` through its plain version."""
    from repro_torch.kernels import ops
    orig = {n: getattr(ops, n) for n in ("lowrank_linear",
                                         "batched_small_eigh")}

    def plain_of(fn):
        def call(*args, **kw):
            with ops.plain_kernels():
                return fn(*args, **kw)
        return call

    for n, fn in orig.items():
        if n != name:
            setattr(ops, n, plain_of(fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def exact_apply():
    """Every kernel's plain version, ``lowrank_linear`` in float64 and
    rounded once."""
    from repro_torch.kernels import lowrank_linear as ll
    from repro_torch.kernels import ops
    orig = ops.lowrank_linear

    def f64(x, w, basis, rt, scale, *, side=None):
        side = side or ll.infer_side(w.shape, basis.shape, rt.shape)
        xd = x.double()
        d = ((xd @ rt.double()) @ basis.double().mT if side == "right"
             else (xd @ basis.double()) @ rt.double())
        s = torch.as_tensor(scale, device=x.device).double()
        return (s * (xd @ w.double()) + d).to(x.dtype)

    ops.lowrank_linear = f64
    try:
        with ops.plain_kernels():
            yield
    finally:
        ops.lowrank_linear = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="1,2,3,4")
    args = ap.parse_args(argv)
    parts = {int(p) for p in args.parts.split(",")}
    if not torch.cuda.is_available():
        print("runtime_floor: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    if 1 in parts:
        print(json.dumps({"part": "apply_rounding", "card": card,
                          "rows": apply_rounding(args.seed)}), flush=True)

    cfg = cs._full_config("qwen1.5-0.5b")
    bats = cs._runtime_batches(cfg, args.seed, 2)
    fed = start = None

    def at_rate(lr):
        nonlocal fed, start
        fed = start = None
        torch.cuda.empty_cache()
        fed = cs._runtime_fed(cfg, args.seed, lr)
        start = cs._fed_state(fed)

    def run(*ctxs):
        cs._set_state(fed, start)
        with contextlib.ExitStack() as stack:
            for ctx in ctxs:
                stack.enter_context(ctx)
            rl = stack.enter_context(cs.RoundLog(runtime=True))
            for b in bats:
                fed.run_round(b)
        return rl

    def reading(a, b):
        diffs = [(x["losses"] - y["losses"]).abs()
                 for x, y in zip(a.rounds, b.rounds)]
        return {"loss_by_round": [d.max().item() for d in diffs],
                "mean_abs_loss": float(np.mean([d.mean().item()
                                                for d in diffs])),
                "delta": cs._change_rel(a.snaps[2], b.snaps[2],
                                        b.snaps[0])[0]}

    nothing = contextlib.nullcontext
    at_rate(cs.TRAIN_LR)
    runs = {"plain": run(ops.plain_kernels())}
    if parts & {2, 3, 4}:
        runs["kernels"] = run(nothing())
    if 2 in parts:
        runs["lowrank_linear_only"] = run(only_kernel("lowrank_linear"))
        runs["jacobi_eigh_only"] = run(only_kernel("batched_small_eigh"))
        print(json.dumps({"part": "by_kernel", "card": card, **{
            name: reading(runs[name], runs["plain"]) for name in
            ("kernels", "lowrank_linear_only", "jacobi_eigh_only")}}),
            flush=True)
    if 3 in parts:
        runs["exact_apply"] = run(exact_apply())
        print(json.dumps({"part": "against_exact_apply", "card": card, **{
            name: reading(runs[name], runs["exact_apply"])
            for name in ("kernels", "plain")}}), flush=True)
    if 4 in parts:
        out = {"part": "faults_by_rate", "card": card, "rates": {}}
        faults = {"fault": run(cs._rolled_lowrank_basis())}
        out["rates"][cs.TRAIN_LR] = {
            name: reading(x, runs["plain"]) for name, x in
            (("kernels", runs["kernels"]), ("fault", faults["fault"]))}
        runs = faults = None
        at_rate(cs.RWKV_LR)
        plain = run(ops.plain_kernels())
        low = {"kernels": run(nothing()),
               **{f"embed_ulp_{i}": run(
                   ops.plain_kernels(),
                   cs._bumped_embedding(fed, args.seed + 5 + i))
                  for i in range(2)},
               **{f"rounding_noise_{i}": run(
                   cs._rounding_noise(args.seed + 13 + i)) for i in range(2)},
               "fault": run(cs._rolled_lowrank_basis())}
        out["rates"][cs.RWKV_LR] = {name: reading(x, plain)
                                    for name, x in low.items()}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
