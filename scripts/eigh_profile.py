"""Time the Jacobi eigensolver's routes, and test how ``torch.profiler``
sees it, on one CUDA card.

  python3 scripts/eigh_profile.py [--seed 0]

Prints JSON lines:

* ``routes``: device ms per call (CUDA-graph replay, ``chip_smoke.graph_ms``)
  of ``jacobi_eigh`` on 384 SPD matrices (the path's largest 𝒮 bucket) at
  n = 8, 16 and 32, launched on each route and layout the source builds:
  ``warp`` in the pair layout (n = 8) and in the column layout with every
  lane count from the next power of two >= n up to 32, ``block`` with 4
  and 8 warps; each launch first checked against the plain version (the
  gates of ``chip_smoke.py``); the planned one also with 0, 1, 2 and 12
  sweeps. ``torch.linalg.eigh`` beside it, by the profiler. This is where
  ``batched_eigh.WARP_MAX_N`` comes from.
* ``layouts``: n = 8 in the pair and the column layout (8 lanes) over
  batches of 96 to 6,144 matrices: where ``PAIR_MAX_BATCH`` comes from.
* ``sass``: each kernel's instructions in the built library.
* ``profiler``: the three 𝒮 buckets profiled as ``chip_smoke.py`` did up
  to PR 18 — one ``torch.profiler`` session per call — 20 times each,
  counting the sessions whose trace holds no ``jacobi`` kernel, once as
  it was and once with a marker kernel launched first in each session;
  for a session that lost the kernel, what the raw Kineto results held.
  Then ``chip_smoke.profiled_ms`` (one session, calls split by markers).

Inputs are random from ``--seed``. Needs a CUDA card; imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BATCH = 384
BUCKETS = [(4, 24, 4), (24, 4), (2, 24, 4)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def forced(be, layout, lanes, warps, sweeps=12):
    """``jacobi_eigh``'s launch with its layout, geometry and sweeps
    given."""
    def fn(a):
        n = a.shape[-1]
        a3 = a.reshape(-1, n, n)
        lam = torch.empty(a3.shape[:2], device=a.device)
        vec = torch.empty_like(a3)
        err = be._lib()(a3.data_ptr(), lam.data_ptr(), vec.data_ptr(),
                        a3.shape[0], n, sweeps, be._LAYOUT_CODE[layout],
                        lanes, warps,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{layout} lanes {lanes} warps {warps}: "
                               f"CUDA error {err}")
        return lam, vec
    return fn


def gates(a, lam, vec, ref):
    """(max eigenvalue error, reconstruction, orthogonality, tolerance), as
    chip_smoke.py checks them, and whether they hold."""
    n = a.shape[-1]
    lam_p, _ = ref.jacobi_eigh_ref(a)
    scale = lam_p.abs().max().item()
    err_l = (lam - lam_p).abs().max().item() / scale
    err_r = ((vec * lam[..., None, :]) @ vec.mT - a).abs().max().item() / scale
    orth = (vec.mT @ vec - torch.eye(n, device=a.device)).abs().max().item()
    tol = 1e-5 * max(n, 8)
    return [err_l, err_r, orth, tol], max(err_l, err_r, orth) <= tol


def sass_histogram():
    """Instructions of each kernel in the built library's SASS
    (``cuobjdump``): the total and the ten commonest opcodes."""
    import re
    from collections import Counter
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.build("batched_eigh"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name, ops = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            found = re.search(r"(jacobi_\w+_kernel)(?:I(.*?)EEv)?",
                              m.group(1))
            name = found.group(1) + (f"<{found.group(2)}>" if found.group(2)
                                     else "") if found else m.group(1)
            ops = out.setdefault(name, Counter())
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if m and ops is not None:
            ops[m.group(1)] += 1
    return {k: {"total": sum(v.values()), "top": dict(v.most_common(10))}
            for k, v in out.items()}


def per_call_sessions(fn, sets, calls, marker):
    """PR 18's way: one profiler session per call. Returns the jacobi
    kernels each session's trace held and, for the first session that
    held none, the device events in the raw Kineto results."""
    from torch.profiler import ProfilerActivity, profile
    seen, lost = [], None
    for i in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if marker:
                torch.cuda._sleep(1000)
            fn(sets[i % len(sets)])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append(sum("jacobi" in n for n in names))
        if seen[-1] == 0 and lost is None:
            raw = prof.profiler.kineto_results.events()
            lost = {"events": names,
                    "raw_device": [e.name() for e in raw
                                   if e.device_type()
                                   == torch.autograd.DeviceType.CUDA]}
    return seen, lost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("eigh_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import batched_eigh as be
    from repro_torch.kernels import ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def checked(fn, a):
        lam, vec = fn(a)
        torch.cuda.synchronize()
        errs, ok = gates(a, lam, vec, ref)
        if not ok:
            raise RuntimeError(f"{tuple(a.shape)} fails the gates: {errs}")
        return errs

    for n in (8, 16, 32):
        sets = [cs._spd_case(gen, (BATCH,), n) for _ in range(2)]
        m = n + (n & 1)
        variants = [("pairs", 32, be.WARPS)] if m == be.PAIR_M else []
        variants += [("columns", lanes, be.WARPS) for lanes in (8, 16, 32)
                     if lanes >= m and n <= be.WARP_MAX_N]
        variants += [("shared", 32 * w, w) for w in (4, 8)]
        p = be.plan(n, BATCH)
        row = {"phase": "routes", "n": n, "batch": BATCH, "card": card,
               "plan": p._asdict(), "graph_ms": {}, "gates": {}}
        for layout, lanes, warps in variants:
            key = f"{layout}/{lanes if layout != 'shared' else warps}"
            fn = forced(be, layout, lanes, warps)
            row["gates"][key] = checked(fn, sets[0])
            row["graph_ms"][key] = cs.graph_ms(fn, sets)
        row["eigh_profiled_ms"] = cs.profiled_ms(torch.linalg.eigh,
                                                 sets)["ms"]
        row["graph_ms_by_sweeps"] = {
            sw: cs.graph_ms(forced(be, p.layout, p.lanes, p.warps, sw), sets)
            for sw in (0, 1, 2, 12)}
        emit(row)
        del sets
    for batch in (96, 384, 768, 1536, 3072, 6144):
        sets = [cs._spd_case(gen, (batch,), 8) for _ in range(2)]
        row = {"phase": "layouts", "n": 8, "batch": batch, "card": card,
               "plan": be.plan(8, batch).layout}
        for layout, lanes in (("pairs", 32), ("columns", 8)):
            fn = forced(be, layout, lanes, be.WARPS)
            checked(fn, sets[0])
            row[layout + "_ms"] = cs.graph_ms(fn, sets)
        emit(row)
        del sets
    emit({"phase": "sass", "card": card, "by_function": sass_histogram()})

    for lead in BUCKETS:
        sets = [cs._spd_case(gen, lead, 8) for _ in range(2)]
        for s in sets:
            be.jacobi_eigh(s)
        torch.cuda.synchronize()
        row = {"phase": "profiler", "a": list(lead) + [8, 8], "card": card}
        for marker in (False, True):
            seen, lost = per_call_sessions(be.jacobi_eigh, sets, 20, marker)
            key = "with_marker" if marker else "as_pr18"
            row[key] = {"sessions": len(seen),
                        "without_kernel": sum(s == 0 for s in seen),
                        "kernels": seen, "a_lost_session": lost}
        row["one_session"] = cs.profiled_ms(be.jacobi_eigh, sets,
                                            counter=be.jacobi_eigh)
        row["graph_ms"] = cs.graph_ms(be.jacobi_eigh, sets)
        emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
