"""Split a serving path's end-to-end parity gap by kernel, on one CUDA card.

  python3 scripts/parity_decompose.py [--arch rwkv6-1.6b] [--seed 0]
  python3 scripts/parity_decompose.py --arch mistral-nemo-12b

Builds the full-width model of ``--arch`` with 8 demo adapters of rank 16
(as ``chip_smoke.py`` does) and runs one prefill of 8 x 128 tokens and 4
decode steps several ways: every kernel, every plain version, each kernel
alone (the other kernels' plain versions in their place), the plain path
twice (determinism), and the plain path with 1 % of the embedding table's
entries moved by one bf16 ulp (the model's own amplification of
rounding). Two planted faults, every kernel on, show what a wrong kernel
reads: each row's adapter id rolled by one (the adapter a wrong gather in
``lowrank_linear_batched`` would apply), and for the dense family a
softmax scale 1 % too large in every ``flash_attention`` call. The
path's kernels: ``lowrank_linear_batched``, and
``rwkv6_scan`` (RWKV6) or ``flash_attention`` (the dense family's
prefill). Prints one JSON line: for each run, max |logit - plain logit|
over max |plain logit|, per forward and overall, and greedy agreement.
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
B, G, R, PROMPT, DECODES = 8, 8, 16, 128, 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parity_decompose: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import adapters as adapters_lib
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    params = model_lib.init_params(cfg, seed=args.seed, device="cuda")
    served = adapters_lib.demo_wrap(params, cfg, G, rank=R,
                                    seed=args.seed + 2)
    rng = np.random.default_rng(args.seed + 3)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, PROMPT),
                                           dtype=np.int32), device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (DECODES, B),
                                        dtype=np.int32), device="cuda")
    ids = torch.arange(B, dtype=torch.int32, device="cuda") % G

    @torch.inference_mode()
    def run(p, ids=ids):
        st = model_lib.init_decode_state(cfg, B, PROMPT + DECODES,
                                         device="cuda")
        outs = []
        with layers.adapter_ids(ids):
            logits, st = model_lib.prefill(p, cfg, prompts, st)
            outs.append(logits)
            for tok in feed:
                logits, st = model_lib.decode_step(p, cfg, tok, st)
                outs.append(logits)
        return torch.stack(outs)

    plain_of = {"lowrank_linear_batched": ops.lowrank_linear_batched_ref,
                "rwkv6_scan": ops.rwkv6_scan_ref,
                "flash_attention": ops.flash_attention_ref}
    kernels = ["lowrank_linear_batched"] + (["rwkv6_scan"] if cfg.rwkv
                                            else ["flash_attention"])

    @contextlib.contextmanager
    def plain_except(keep):
        """Every kernel of the path but ``keep`` runs its plain version."""
        saved = {name: getattr(ops, name) for name in kernels}
        for name in kernels:
            if name != keep:
                ref = plain_of[name]
                setattr(ops, name, lambda *a, _ref=ref, chunk=None, **kw:
                        _ref(*a, **kw))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(ops, name, fn)

    with ops.plain_kernels():
        plain = run(served)
    scale = plain.abs().max().item()

    def reading(got):
        per = [(g - w).abs().max().item() / scale for g, w in zip(got, plain)]
        agree = (got.argmax(-1) == plain.argmax(-1)).float().mean().item()
        return {"max": max(per), "per_forward": per, "greedy_agreement": agree}

    out = {"arch": cfg.name, "logit_scale": scale,
           "all_kernels": reading(run(served))}
    for name in kernels:
        with plain_except(name):
            out[f"{name}_alone"] = reading(run(served))
    out["fault_adapter_ids_rolled"] = reading(run(served, (ids + 1) % G))
    if not cfg.rwkv:
        flash = ops.flash_attention

        def wrong_scale(q, k, v, *, scale=None, **kw):
            scale = q.shape[-1] ** -0.5 if scale is None else scale
            return flash(q, k, v, scale=1.01 * scale, **kw)

        ops.flash_attention = wrong_scale
        try:
            out["fault_flash_scale_1pct"] = reading(run(served))
        finally:
            ops.flash_attention = flash
    with ops.plain_kernels():
        out["plain_again"] = reading(run(served))
        emb = served["embed"]["w"]
        noise = torch.Generator(device="cuda")
        noise.manual_seed(args.seed + 5)
        moved = torch.rand(emb.shape, generator=noise, device="cuda") < 0.01
        bumped = torch.where(moved, torch.nextafter(
            emb, torch.full_like(emb, float("inf"))), emb)
        out["plain_embed_ulp_control"] = reading(
            run(dict(served, embed={"w": bumped})))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
