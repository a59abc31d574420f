"""Fused GaLore preconditioner and GaLoreAdamW step (port of
``repro/kernels/galore_adamw.py``).

For a stack of projected blocks — right side: basis (…, N, r), moments
(…, M, r); left side: basis (…, M, r), moments (…, r, N) —

  g̃ = g B | Bᵀ g;  m' = β₁m + (1-β₁)g̃;  v' = β₂v + (1-β₂)g̃²;
  ũ = (m'/c₁) / (√(v'/c₂) + ε)

and then ũ itself (``project_back=False``, the factored client path),
its lift ``ũBᵀ | Bũ`` (``galore_precond_step``), or the weight update
``w ← w − lr·u − lr·λ·w`` (``galore_adamw_step``). The kernels are CUDA
C++ for sm_90a (``csrc/galore_adamw.cu``, which says what bounds them),
built with ``nvcc`` at first launch and called through ``ctypes`` on
PyTorch's current stream. The stacked leading dims flatten into the grid.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

RIGHT = "right"
LEFT = "left"
MAX_RANK = 64
_SMEM_REFUSED = 9          # cudaErrorInvalidConfiguration


def infer_side(w_shape, basis_shape, m_shape) -> str:
    """Recover the projection side from buffer shapes (right ⇒ basis (N, r),
    moments (M, r); left ⇒ basis (M, r), moments (r, N)). Square blocks with
    r == M default to right, the ``proj_type=std`` convention."""
    mm, nn = tuple(w_shape)[-2:]
    dim, r = tuple(basis_shape)[-2:]
    if dim == nn and tuple(m_shape)[-2:] == (mm, r):
        return RIGHT
    if dim == mm and tuple(m_shape)[-2:] == (r, nn):
        return LEFT
    raise ValueError(f"inconsistent galore shapes: w {tuple(w_shape)}, "
                     f"basis {tuple(basis_shape)}, m {tuple(m_shape)}")


def bias_corrections(count, b1: float, b2: float, bias_correction=True):
    """``(1 - β₁^count, 1 - β₂^count)`` in fp32, as the reference computes
    them in the kernel from its fp32 count; (1, 1) without correction."""
    if not bias_correction:
        return 1.0, 1.0
    c = torch.tensor(float(count), dtype=torch.float32)
    return (float(1 - torch.tensor(b1, dtype=torch.float32) ** c),
            float(1 - torch.tensor(b2, dtype=torch.float32) ** c))


def _lib():
    lib = _build.load("galore_adamw")
    fn = lib.galore_adamw_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(g, basis, m, v, w, u, mode, side, *, b1, b2, eps, c1, c2, lr,
            wd, m_out, v_out) -> bool:
    """Check the operands and launch; returns whether a kernel was
    launched (False for an empty batch)."""
    dev = g.device
    for name, ten in (("g", g), ("basis", basis), ("m", m), ("v", v),
                      ("w", w), ("u", u)):
        if ten is None:
            continue
        if ten.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {ten.device}: every operand must be "
                             f"on one CUDA device (g is on {dev})")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "w" and ten.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {ten.dtype}")
    if w is not None and w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    mm, nn = g.shape[-2:]
    r = basis.shape[-1]
    want_b, want_m = ((nn, r), (mm, r)) if side == RIGHT else \
        ((mm, r), (r, nn))
    lead = g.shape[:-2]
    if tuple(basis.shape) != lead + want_b or \
            tuple(m.shape) != lead + want_m or m.shape != v.shape or \
            (w is not None and w.shape != g.shape):
        raise ValueError(f"{side} side shapes: g {tuple(g.shape)}, basis "
                         f"{tuple(basis.shape)} (want {lead + want_b}), m "
                         f"{tuple(m.shape)}, v {tuple(v.shape)} (want "
                         f"{lead + want_m})")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    batch = g.numel() // (mm * nn) if mm * nn else 0
    if batch == 0:
        return False
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(g.data_ptr(), basis.data_ptr(), m.data_ptr(), v.data_ptr(),
                 m_out.data_ptr(), v_out.data_ptr(),
                 None if u is None else u.data_ptr(),
                 None if w is None else w.data_ptr(),
                 int(w is not None and w.dtype == torch.bfloat16), batch, mm,
                 nn, r, 0 if side == RIGHT else 1, mode, b1, 1.0 - b1, b2,
                 1.0 - b2, eps, c1, c2, lr, wd, stream)
    if err == _SMEM_REFUSED:
        raise ValueError(f"galore kernel: the {side} basis "
                         f"{tuple(basis.shape[-2:])} does not fit in the "
                         "device's shared memory per block")
    if err != 0:
        raise RuntimeError(f"galore kernel launch failed: CUDA error {err}")
    return True


def galore_precond_step(g, basis, m, v, count, *, side=None, b1=0.9,
                        b2=0.999, eps=1e-8, bias_correction=True,
                        project_back=True):
    """Launch the fused preconditioner on CUDA tensors; returns (u, m', v')
    with u (…, M, N) fp32, or ũ in the moment shape when ``project_back``
    is False. ``count`` is the post-increment step (a host number). All
    operands fp32 and contiguous. ``galore_precond_step.launches`` counts
    the launches."""
    side = side or infer_side(g.shape, basis.shape, m.shape)
    c1, c2 = bias_corrections(count, b1, b2, bias_correction)
    u = torch.empty(g.shape if project_back else m.shape,
                    dtype=torch.float32, device=g.device)
    m_out, v_out = torch.empty_like(m), torch.empty_like(v)
    if _launch(g, basis, m, v, None, u, 1 if project_back else 0, side,
               b1=b1, b2=b2, eps=eps, c1=c1, c2=c2, lr=0.0, wd=0.0,
               m_out=m_out, v_out=v_out):
        galore_precond_step.launches += 1
    return u, m_out, v_out


galore_precond_step.launches = 0


def galore_adamw_step(w, g, basis, m, v, count, *, side=None, b1=0.9,
                      b2=0.999, eps=1e-8, lr=1e-3, weight_decay=0.0,
                      bias_correction=True):
    """Launch the fused GaLoreAdamW step on CUDA tensors; returns
    (w', m', v'), w' in w's dtype (fp32 or bf16). ``count`` is the
    post-increment step. ``galore_adamw_step.launches`` counts the
    launches."""
    side = side or infer_side(w.shape, basis.shape, m.shape)
    c1, c2 = bias_corrections(count, b1, b2, bias_correction)
    w_out = w.clone()
    m_out, v_out = torch.empty_like(m), torch.empty_like(v)
    if _launch(g, basis, m, v, w_out, None, 2, side, b1=b1, b2=b2, eps=eps,
               c1=c1, c2=c2, lr=lr, wd=weight_decay, m_out=m_out,
               v_out=v_out):
        galore_adamw_step.launches += 1
    return w_out, m_out, v_out


galore_adamw_step.launches = 0
