"""Time the fused GaLore kernel and one local step's GaLore update on one
CUDA card, for this tree's package or another tree's.

  python3 scripts/galore_profile.py [--src DIR] [--variants] [--seed 0]

Prints JSON lines, each with the card's name and power limit:

* ``bucket``: device ms (CUDA-graph replay, ``chip_smoke.graph_ms``) of
  ``galore_precond_step`` at round 0's three buckets, project_back
  False, with fp32 g and, where the tree's kernel takes one, bf16 g;
  the byte bound beside it (g in its own type, the basis, m and v read,
  m', v' and ũ written).
* ``update``: eager ms (CUDA events) of one local step's GaLore update
  (``chip_smoke.galore_update_rows``: the bucket stacks, any cast and the
  three launches, on fp32 and bf16 gradients, and the whole clipped
  ``factored_adamw_step``).
* ``variant`` (with ``--variants``): the kernel source of this tree
  built again with each alternative of ``VARIANTS`` (compile-time
  switches of ``csrc/galore_adamw.cu``) and timed at the three
  buckets; each first run on the same inputs as the first variant and
  held to its outputs bit for bit (the arithmetic order is the same),
  a bf16 g to its fp32 copy likewise, with the error against the plain
  version printed.

``--src`` points at another tree's ``src`` (a parent unpacked with ``git
archive``), whose package is imported and built in its own ``build/``;
``chip_smoke`` is this tree's. Inputs are random from ``--seed``. Needs a
CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = [((4, 24), 1024, 1024), ((2, 24), 1024, 2816),
           ((1, 24), 2816, 1024)]
# name: (nvcc -D flags, the g types on the ring): the shipped kernel (bf16
# g through a cp.async ring, fp32 g into registers), every g into
# registers, every 16-byte row through the ring.
VARIANTS = {"shipped": ([], (torch.bfloat16,)),
            "registers": (["-DGALORE_RING_BF16=0"], ()),
            "ring_everywhere": (["-DGALORE_RING_FP32=1"],
                                (torch.bfloat16, torch.float32))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bucket_rows(cs, ga, gen, card, dtypes, tag):
    rows = []
    for (lead, mm, nn) in BUCKETS:
        for dtype in dtypes:
            sets = [cs._precond_case(gen, lead, mm, nn, dtype=dtype)
                    for _ in range(2)]
            c = sets[0]
            nbytes = (c["g"].numel() * c["g"].element_size()
                      + 4 * (c["basis"].numel() + 5 * c["m"].numel()))
            ms = cs.graph_ms(lambda c: ga.galore_precond_step(
                c["g"], c["basis"], c["m"], c["v"], 3, side=c["side"],
                project_back=False), sets)
            rows.append({"phase": "bucket", "tree": tag, "card": card,
                         "g": list(c["g"].shape),
                         "g_dtype": str(dtype).split(".")[1],
                         "device_ms": ms,
                         "bound_ms": nbytes / cs.PEAK_BYTES * 1e3,
                         "of_bound": nbytes / cs.PEAK_BYTES * 1e3 / ms})
            emit(rows[-1])
            del sets
    return rows


def variants(cs, gen, card):
    """Each VARIANTS build of this tree's source, timed and checked."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import galore_adamw as ga
    from repro_torch.kernels import ref
    out = _build.BUILD_DIR / "galore_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (flags, _) in VARIANTS.items():
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(_build.CSRC / "galore_adamw.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    rings0, lib0 = ga.RING_DTYPES, ga._lib
    c1, c2 = ga.bias_corrections(3, 0.9, 0.999)
    cases = [cs._precond_case(gen, lead, mm, nn) for (lead, mm, nn) in
             BUCKETS + [((3,), 45, 40), ((2,), 40, 48)]]
    first = {}          # the first variant's outputs, by (case, g type)
    try:
        for name, (lib, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{log}")
            fn = ctypes.CDLL(str(lib)).galore_adamw_launch
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                           + [ctypes.c_float] * 9 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            ga.RING_DTYPES = VARIANTS[name][1]
            ga.plan.cache_clear()
            ga._lib = lambda fn=fn: fn
            summary = [f for f in cs.ptxas_summary(log) if "Li8E" in
                       f["function"]]
            for ci, c in enumerate(cases):
                g16 = c["g"].to(torch.bfloat16)
                got = {}
                for tag, g in (("float32", c["g"]), ("bfloat16", g16),
                               ("copy", g16.float())):
                    got[tag] = ga.galore_precond_step(
                        g, c["basis"], c["m"], c["v"], 3, side=c["side"],
                        project_back=False)
                    want = ref.galore_precond_ref(
                        g, c["basis"], c["m"], c["v"], c1=c1, c2=c2,
                        side=c["side"], project_back=False)
                    errs = [cs._rel(a, b) for a, b in zip(got[tag], want)]
                    same = all(torch.equal(a, b) for a, b in zip(
                        got[tag], first.setdefault((ci, tag), got[tag])))
                    emit({"phase": "variant_check", "variant": name,
                          "g": list(g.shape), "g_dtype": tag,
                          "rel_err_u_m_v": errs,
                          "equal_to_first_variant": same})
                    cs.check(same, f"variant {name} at {tuple(g.shape)} "
                             f"{tag} differs from {next(iter(VARIANTS))}")
                cs.check(all(torch.equal(a, b) for a, b in
                             zip(got["bfloat16"], got["copy"])),
                         f"variant {name}: bf16 g differs from its copy")
            for (lead, mm, nn) in BUCKETS:
                for dtype in (torch.float32, torch.bfloat16):
                    sets = [cs._precond_case(gen, lead, mm, nn, dtype=dtype)
                            for _ in range(2)]
                    c = sets[0]
                    nbytes = (c["g"].numel() * c["g"].element_size()
                              + 4 * (c["basis"].numel()
                                     + 5 * c["m"].numel()))
                    p = ga.plan(c["side"], mm, nn, 8, dtype, 0,
                                batch=c["g"].numel() // (mm * nn))
                    ms = cs.graph_ms(lambda c: ga.galore_precond_step(
                        c["g"], c["basis"], c["m"], c["v"], 3,
                        side=c["side"], project_back=False), sets)
                    emit({"phase": "variant", "variant": name, "card": card,
                          "g": list(c["g"].shape),
                          "g_dtype": str(dtype).split(".")[1],
                          "route": p.route, "grid": list(p.grid),
                          "smem": p.smem,
                          "device_ms": ms,
                          "of_bound": nbytes / cs.PEAK_BYTES * 1e3 / ms,
                          "ptxas_rank8": summary})
                    del sets
    finally:
        ga.RING_DTYPES, ga._lib = rings0, lib0
        ga.plan.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("galore_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import galore_adamw as ga
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    tag = str(Path(args.src).resolve().relative_to(ROOT))
    _build.build("galore_adamw")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    dtypes = (torch.float32, torch.bfloat16) if hasattr(ga, "plan") \
        else (torch.float32,)
    bucket_rows(cs, ga, gen, card, dtypes, tag)
    for row in cs.galore_update_rows(gen, card):
        emit({**row, "phase": "update", "tree": tag})
    if args.variants:
        variants(cs, gen, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
