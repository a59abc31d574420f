"""How far rounding alone moves an MoE model's free-routing logits, on one CUDA card.

  python3 scripts/moe_parity_floor.py [--arch deepseek-v2-236b ...]
                                      [--seeds 0 1 2 3] [--bumps 8]

For each arch and seed, builds the served model as ``chip_smoke.py``'s
serving phase does (the registered full-width bf16 config, its depth cut
by ``chip_smoke.CUT_LAYERS``, 8 demo adapters of rank 16, all drawn from
the seed) and reads ``chip_smoke.parity_readings`` twice, with ``--bumps``
controls each: one prefill of 8 x 128 tokens and 4 decode steps through
the kernels, through their plain versions, through the plain versions
with 1 % of the embedding table one bf16 ulp up (one run for each draw of
the moved entries), and with each row's adapter id rolled by one; the
same runs pinned to the plain run's experts. The second reading gives
the kernel and plain paths run again (an MoE layer's scatter-add is
atomic on the card, so a run need not repeat itself bit for bit).
Prints one JSON line per (arch, seed): every reading as max |logit -
plain logit| over max |plain logit|, the expert-choice flip shares of
the kernel run, each control and the fault, and the kernel reading over
the largest control (``kernel_over_max_control``).
These are the readings ``phase_parity``'s free-routing floor was chosen
from. Needs a CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["deepseek-v2-236b", "jamba-1.5-large-398b",
                             "granite-moe-1b-a400m"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--bumps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_parity_floor: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.launch import adapters as adapters_lib
    from repro_torch.models import model as model_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    for arch in args.arch:
        cfg = cs._full_config(arch)
        for seed in args.seeds:
            params = model_lib.init_params(cfg, seed=seed, device="cuda")
            served = adapters_lib.demo_wrap(params, cfg, cs.G, rank=cs.R,
                                            seed=seed + 2)
            del params
            first = cs.parity_readings(cfg, served, seed, bumps=args.bumps)
            again = cs.parity_readings(cfg, served, seed, bumps=1)
            want = first["want"]
            scale = want.abs().max().item()

            def rel(x, want=want, scale=scale):
                return cs._logit_rel(x, want, scale)

            routes = first["routes"]
            controls = [rel(c) for c in first["controls"]]
            row = {
                "arch": arch, "seed": seed, "n_layers": cfg.n_layers,
                "bumps": args.bumps, "logit_scale": scale,
                "kernel": rel(first["got"]),
                "kernel_again": rel(again["got"]),
                "plain_again": rel(again["want"]),
                "controls": controls, "max_control": max(controls),
                "kernel_over_max_control": rel(first["got"]) / max(controls),
                "fault": rel(first["fault"]),
                "flip_share": cs.routing_flip_share(routes["got"],
                                                    routes["want"]),
                "control_flip_shares": [
                    cs.routing_flip_share(c, routes["want"])
                    for c in routes["controls"]],
                "fault_flip_share": cs.routing_flip_share(routes["fault"],
                                                          routes["want"]),
                "pinned": {k: rel(v) for k, v in first["pinned"].items()},
                "card": card}
            print(json.dumps(row), flush=True)
            del served, first, again
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
