"""Split the low-rank applies' device time by pass, on one CUDA card.

  python3 scripts/lowrank_profile.py [--seed 0]

Each call of ``lowrank_linear_batched`` or ``lowrank_linear`` launches up
to four kernels on its route (tc_gemm: the shrink, the sum of its K
pieces, the GEMM, the reduce when K is split; tc_decode: the streaming
GEMM with the shrink folded in, the reduce). For every (m, n) of the
serving paths at decode (8, 1) and prefill (8, 128) and (1, 128), and
the training shapes at (4, 128), this profiles nine calls
(``torch.profiler``, device time of each kernel) and prints one JSON line
per shape: the route, the plan and microseconds per call by kernel.
Inputs are random bf16 from ``--seed``, 8 adapters of rank 16 (training:
one of rank 8). Needs a CUDA card; imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SERVE_MN = [(1024, 1024), (1024, 2816), (2816, 1024),     # qwen1.5-0.5b
            (2048, 2048), (2048, 7168), (7168, 2048),     # rwkv6-1.6b
            (4608, 4608), (4608, 512), (4608, 18432),     # starcoder2-7b
            (18432, 4608)]
TRAIN_MN = [(1024, 1024), (1024, 2816), (2816, 1024)]
G, R, TRAIN_R, REPS = 8, 16, 8, 9


def per_kernel_us(fn, sets, tries=3):
    """Device microseconds per call of each kernel ``fn`` launches. A
    profile that recorded no device event is taken again, up to
    ``tries`` times; raises if none did."""
    from torch.profiler import ProfilerActivity, profile
    for c in sets:
        fn(c)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(REPS):
                fn(sets[i % len(sets)])
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            total = getattr(ev, "device_time_total", 0)
            if total:
                found = re.search(r"::(\w+(?:<[^>(]*>)?)", ev.key)
                name = found.group(1) if found else ev.key[:40]
                out[name] = out.get(name, 0.0) + total / REPS
        if out:
            return out
    raise RuntimeError("the profiler recorded no device time")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lowrank_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import lowrank_linear as ll
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    def batched_case(b, t, m, n):
        side = "right" if m >= n else "left"
        bdim = n if side == "right" else m
        return dict(x=rnd(b, t, m).to(torch.bfloat16),
                    w=rnd(m, n, scale=m ** -0.5).to(torch.bfloat16),
                    bases=rnd(G, bdim, R, scale=bdim ** -0.5),
                    rts=rnd(*((G, m, R) if side == "right" else (G, R, n)),
                            scale=0.02),
                    scales=1.0 + rnd(G, scale=0.1),
                    ids=torch.arange(b, dtype=torch.int32,
                                     device="cuda") % G, side=side)

    def single_case(m, n):
        side = "right" if m >= n else "left"
        dim = n if side == "right" else m
        return dict(x=rnd(4, 128, m).to(torch.bfloat16),
                    w=rnd(m, n, scale=0.02).to(torch.bfloat16),
                    basis=torch.linalg.qr(rnd(dim, TRAIN_R))[0].contiguous(),
                    rt=rnd(*((m, TRAIN_R) if side == "right"
                             else (TRAIN_R, n)), scale=0.01),
                    scale=torch.tensor(0.999, device="cuda"), side=side)

    def batched(c):
        return ll.lowrank_linear_batched(c["x"], c["w"], c["bases"],
                                         c["rts"], c["scales"], c["ids"],
                                         side=c["side"])

    def single(c):
        return ll.lowrank_linear(c["x"], c["w"], c["basis"], c["rt"],
                                 c["scale"], side=c["side"])

    runs = [("lowrank_linear_batched", b, t, m, n)
            for m, n in SERVE_MN for b, t in ((8, 1), (8, 128), (1, 128))]
    runs += [("lowrank_linear", 4, 128, m, n) for m, n in TRAIN_MN]
    for kernel, b, t, m, n in runs:
        if kernel == "lowrank_linear":
            sets, fn, tp = [single_case(m, n) for _ in range(2)], single, b * t
        else:
            sets, fn, tp = ([batched_case(b, t, m, n) for _ in range(2)],
                            batched, t)
        route = ll.route(b * t, m, n, R, torch.bfloat16, torch.bfloat16)
        us = per_kernel_us(fn, sets)
        print(json.dumps({"kernel": kernel, "B": b, "t": t, "m": m, "n": n,
                          "route": route,
                          "plan": ll.plan(route, b * t, tp, m, n,
                                          sms)._asdict(),
                          "us_per_call": us, "total_us": sum(us.values()),
                          "card": card}), flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
