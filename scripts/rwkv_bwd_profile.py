"""Time the WKV backward kernel ``rwkv6_scan_bwd`` on one CUDA card, for
this tree's package or another tree's, and count its SASS.

  python3 scripts/rwkv_bwd_profile.py [--src DIR] [--seed 0]

Prints JSON lines, each with the card's name and power limit:

* ``build``: the tree's kernel built, with ptxas's registers and spills
  and the SASS counts of the <bf16, fp32> instance (``SHFL``, ``LDS``,
  ``STS``, ``BAR``, ``LDG``, ``STG``, ``LDGSTS``, ``FFMA``, ``FMUL``,
  ``FADD``, all instructions, the 16 commonest) from ``cuobjdump``;
* ``time``: device ms (CUDA-graph replay, ``chip_smoke.graph_ms``) and
  eager ms of one call, beside its bound (``chip_smoke.rwkv_bwd_bound``),
  at rwkv6-1.6b's training layer (4, 128, 32, 64) with bf16 r/k/v/dy and
  fp32 w, then over L (8, 32, 128, 512) at 128 (b, h) and over B·H (32,
  128, 256, 512) at L = 128; every case first checked bit for bit against
  ``ref.rwkv6_scan_bwd_ref``;
* ``fit``: the time against L split into a fixed cost and a per-step
  slope (least squares over the L sweep).

``--src`` points at another tree's ``src`` (a parent unpacked with ``git
archive``), whose package is imported and built in its own ``build/``;
``chip_smoke`` is this tree's. Inputs are random from ``--seed``. Needs a
CUDA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TRAIN = (4, 128)                       # (B, L) at H 32, D 64
L_SWEEP = (8, 32, 128, 512)
B_SWEEP = (1, 4, 8, 16)                # B·H 32 … 512 at H 32
OPCODES = ("SHFL", "LDS", "STS", "BAR", "LDG", "STG", "LDGSTS", "FFMA",
           "FMUL", "FADD")
_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)")


def sass_counts(lib: Path, nvcc: str) -> dict:
    """Opcode counts of the backward kernel's <bf16, fp32> instance."""
    tool = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:] if f.startswith("_Z")
                 and "wkv6_bwd_kernel" in f.split()[0]
                 and "13__nv_bfloat16f" in f.split()[0]), "")
    ops = _OP.findall(body)
    out = {op: ops.count(op) for op in OPCODES}
    out["all"] = len(ops)
    out["top"] = dict(Counter(ops).most_common(16))
    return out


def cases(cs, scan_mod, gen, b, l):
    """Two input sets of shape (b, l, 32, 64) with their checkpoints."""
    sets = [cs._bwd_case(gen, b, l) for _ in range(2)]
    for c in sets:
        c["ck"] = scan_mod.rwkv6_scan(c["r"], c["k"], c["v"], c["w"],
                                      c["u"], c["s0"], checkpoints=True)[2]
    return sets


def call(scan_mod, c):
    return scan_mod.rwkv6_scan_bwd(c["r"], c["k"], c["v"], c["w"], c["u"],
                                   c["ck"], c["dy"], c["ds"])


def bit_identical(ref, got, c) -> bool:
    want = ref.rwkv6_scan_bwd_ref(c["r"], c["k"], c["v"], c["w"], c["u"],
                                  c["s0"], c["dy"], c["ds"])
    return all(torch.equal(x, y) for x, y in zip(got, want))


def plan_of(scan_mod, b, l):
    """The tree's backward plan as a dict (a parent's ``bwd_plan(l)`` gave
    only its chunk count)."""
    try:
        return scan_mod.bwd_plan(b, l, 32)._asdict()
    except TypeError:
        return {"chunks": scan_mod.bwd_plan(l)}


def timings(cs, scan_mod, ref, gen, card, tag, emit):
    rows = []
    shapes = [(sweep, b, l) for sweep, pts in
              (("train", [TRAIN]), ("L", [(4, l) for l in L_SWEEP]),
               ("BH", [(b, 128) for b in B_SWEEP])) for b, l in pts]
    for sweep, b, l in shapes:
        sets = cases(cs, scan_mod, gen, b, l)
        same = bit_identical(ref, call(scan_mod, sets[0]), sets[0])
        cs.check(same, f"{tag}: rwkv6_scan_bwd at ({b}, {l}, 32, 64) is "
                 "not bit for bit its plain version")
        bound, by = cs.rwkv_bwd_bound(sets[0])
        row = {"phase": "time", "tree": tag, "card": card, "sweep": sweep,
               "B": b, "L": l, "H": 32, "D": 64, "bh": b * 32,
               "plan": plan_of(scan_mod, b, l), "bit_identical": same,
               "device_ms": cs.graph_ms(lambda c: call(scan_mod, c), sets),
               "bound_ms": bound, "bound_by": by}
        if sweep == "train":
            row["ms"] = cs.time_ms(lambda c: call(scan_mod, c), sets)
        row["of_bound"] = bound / row["device_ms"]
        row["us_per_step"] = row["device_ms"] * 1e3 / max(l, 1)
        rows.append(row)
        emit(row)
        del sets
    pts = [(r["L"], r["device_ms"]) for r in rows if r["sweep"] == "L"]
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    slope = (sum((x - mx) * (y - my) for x, y in pts)
             / sum((x - mx) ** 2 for x, _ in pts))
    emit({"phase": "fit", "tree": tag, "card": card,
          "fixed_ms": my - slope * mx, "us_per_step": slope * 1e3,
          "us_per_chunk_of_8": slope * 8e3,
          "bound_us_per_step": rows[0]["bound_ms"] * 1e3 / TRAIN[1]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rwkv_bwd_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref
    scan_mod = cs._scan_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    tag = os.path.relpath(Path(args.src).resolve(), ROOT)
    _build.build("rwkv6_scan")
    lib = _build.build("rwkv6_scan_bwd")
    cs.emit({"phase": "build", "tree": tag, "card": card,
             "ptxas": cs.ptxas_summary(_build.PTXAS_LOG.get(
                 "rwkv6_scan_bwd", "")),
             "sass": sass_counts(lib, _build.nvcc())})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timings(cs, scan_mod, ref, gen, card, tag, cs.emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
