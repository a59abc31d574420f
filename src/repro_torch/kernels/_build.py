"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
for ``sm_90a``, into ``build/repro_torch/lib<name>-<hash>.so`` under the
repository root (``.gitignore`` lists ``build/``). The hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source never loads a stale library. Nothing is built at import: the first
launch builds. :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}      # name -> nvcc's -Xptxas -v report


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` into a temporary file beside its
    library; None if the library exists."""
    path = _lib_path(name)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish(name: str, job) -> str:
    """Wait for a build :func:`_start` began and move its library into
    place. Returns the failure report, or "" when it built."""
    path, tmp, proc = job
    PTXAS_LOG[name] = proc.communicate()[0]
    if proc.returncode != 0:
        return f"{name}: nvcc exited {proc.returncode}\n{PTXAS_LOG[name]}"
    os.replace(tmp, path)
    return ""


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists. Raises with
    the compiler's output if ``nvcc`` fails."""
    job = _start(name)
    if job is not None:
        failed = _finish(name, job)
        if failed:
            raise RuntimeError(f"CUDA build failed:\n{failed}")
    return _lib_path(name)


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu`` not yet built, one ``nvcc`` process per
    source, all started together. Returns each name's build seconds
    (0 for a library that was already there); raises with the compiler's
    output if any build fails."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {name: _start(name) for name in names}
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, job in jobs.items():
        if job is None:
            continue
        failed.append(_finish(name, job))
        seconds[name] = time.perf_counter() - t0
    failed = [f for f in failed if f]
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        path = build(name)
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
