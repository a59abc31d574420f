"""Batched small symmetric eigensolver (port of
``repro/kernels/batched_eigh.py::jacobi_eigh``).

Parallel-order cyclic Jacobi on a (…, n, n) symmetric stack, n ≤ 64, a
fixed 12 sweeps, eigenvalues ascending with matching eigenvector columns
(the ``eigh`` convention). The kernel is CUDA C++ for sm_90a
(``csrc/batched_eigh.cu``: one block per matrix, A and V in shared
memory), built with ``nvcc`` at first launch and called through
``ctypes`` on PyTorch's current stream. Its plain version is
``ref.jacobi_eigh_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_JACOBI_DIM = 64


def _lib():
    lib = _build.load("batched_eigh")
    fn = lib.jacobi_eigh_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def jacobi_eigh(a, *, sweeps: int = 12):
    """Launch the Jacobi kernel on a CUDA (…, n, n) fp32 stack; returns
    ``(lam, vec)``. Raises for n > 64 or a non-square, non-CUDA or
    non-fp32 input. ``jacobi_eigh.launches`` counts the launches."""
    n = a.shape[-1]
    if a.ndim < 2 or a.shape[-2] != n:
        raise ValueError(f"square matrices required, got {tuple(a.shape)}")
    if not 1 <= n <= MAX_JACOBI_DIM:
        raise ValueError(f"jacobi_eigh handles 1 <= n <= {MAX_JACOBI_DIM}, "
                         f"got n={n} (use torch.linalg.eigh)")
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"a must be a float32 CUDA tensor, got {a.dtype} "
                         f"on {a.device}")
    lead = a.shape[:-2]
    a3 = a.reshape((-1, n, n)).contiguous()
    batch = a3.shape[0]
    lam = torch.empty((batch, n), dtype=torch.float32, device=a.device)
    vec = torch.empty((batch, n, n), dtype=torch.float32, device=a.device)
    if batch:
        err = _lib()(a3.data_ptr(), lam.data_ptr(), vec.data_ptr(), batch, n,
                     sweeps, torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"jacobi_eigh launch failed: CUDA error {err}")
        jacobi_eigh.launches += 1
    return lam.reshape(lead + (n,)), vec.reshape(lead + (n, n))


jacobi_eigh.launches = 0
