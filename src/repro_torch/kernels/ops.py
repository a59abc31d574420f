"""Public kernel entry points: CUDA tensors launch the hand-written kernel,
CPU tensors take its plain PyTorch version (port of
``repro/kernels/ops.py``).

The choice follows the tensors' device, never a failure: a kernel that
does not build or launch raises. :func:`plain_kernels` runs every plain
version on the card too, so a caller can compare the kernels against
them; it is never the default.
"""
from __future__ import annotations

import contextlib

import torch

from . import batched_eigh as _eigh
from . import flash_attention as _flash
from . import galore_adamw as _galore
from . import lowrank_linear as _ll
from . import rwkv6_scan as _rwkv
from .ref import (flash_attention_ref, galore_adamw_ref, galore_precond_ref,
                  jacobi_eigh_ref, lowrank_linear_batched_ref,
                  lowrank_linear_ref, rwkv6_scan_bwd_ref, rwkv6_scan_ref)

MAX_JACOBI_DIM = _eigh.MAX_JACOBI_DIM
_PLAIN = [0]   # depth of open plain_kernels() contexts


@contextlib.contextmanager
def plain_kernels():
    """Run every kernel's plain version in its place, on any device."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


def _kernel(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and not _PLAIN[0]


def _one_device(name, *tensors):
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} operands are on mixed devices: "
                         f"{sorted(str(d) for d in devices)}")


def lowrank_linear(x, w, basis, rt, scale, *, side=None):
    """``y = scale·(x @ w) + split-matmul(x, basis, rt)`` for one factored
    block — see ``kernels.lowrank_linear``. ``scale`` is a float or a
    one-value tensor; factors are taken as fp32."""
    side = side or _ll.infer_side(w.shape, basis.shape, rt.shape)
    if not _kernel(x):
        return lowrank_linear_ref(x, w, basis, rt, scale, side=side)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    _one_device("lowrank_linear", x, w, basis, rt, scale)
    return _ll.lowrank_linear(
        x.contiguous(), w.contiguous(), basis.float().contiguous(),
        rt.float().contiguous(), scale.reshape(()).contiguous(), side=side)


def lowrank_linear_batched(x, w, bases, rts, scales, ids, *, side=None):
    """``y[b] = scales[ids[b]]·(x[b] @ w) + split-matmul(x[b],
    bases[ids[b]], rts[ids[b]])`` — see ``kernels.lowrank_linear``.

    All operands must sit on one device. Tables and scales are taken as
    fp32 and ids as int32 (no copy when they already are).
    """
    _one_device("lowrank_linear_batched", x, w, bases, rts, scales, ids)
    side = side or _ll.infer_side(w.shape, bases.shape[1:], rts.shape[1:])
    if not _kernel(x):
        return lowrank_linear_batched_ref(x, w, bases, rts, scales, ids,
                                          side=side)
    return _ll.lowrank_linear_batched(
        x.contiguous(), w.contiguous(), bases.to(torch.float32).contiguous(),
        rts.to(torch.float32).contiguous(),
        scales.to(torch.float32).contiguous(),
        ids.to(torch.int32).contiguous(), side=side)


def _kernel_g(g):
    """g as the GaLore kernel reads it: fp32 or bf16 as it is, any other
    type cast to fp32 (the plain versions compute in fp32 either way)."""
    return (g if g.dtype in _galore.G_DTYPES else g.float()).contiguous()


def galore_precond_step(g, basis, m, v, count, *, side=None, b1=0.9,
                        b2=0.999, eps=1e-8, bias_correction=True,
                        project_back=True):
    """Fused project → Adam → project-back on a stack of blocks; returns
    (u, m', v') — ``u`` fp32 (…, M, N), or ũ in the moment shape when
    ``project_back`` is False. ``count`` is the post-increment step. The
    kernel reads an fp32 or bf16 g as it is; the conversion to fp32 is
    exact, so either gives the same result."""
    _one_device("galore_precond_step", g, basis, m, v)
    side = side or _galore.infer_side(g.shape, basis.shape, m.shape)
    if not _kernel(g):
        c1, c2 = _galore.bias_corrections(count, b1, b2, bias_correction)
        return galore_precond_ref(g, basis, m, v, c1=c1, c2=c2, side=side,
                                  b1=b1, b2=b2, eps=eps,
                                  project_back=project_back)
    return _galore.galore_precond_step(
        _kernel_g(g), basis.float().contiguous(),
        m.float().contiguous(), v.float().contiguous(), count, side=side,
        b1=b1, b2=b2, eps=eps, bias_correction=bias_correction,
        project_back=project_back)


def galore_adamw_step(w, g, basis, m, v, count, *, side=None, b1=0.9,
                      b2=0.999, eps=1e-8, lr=1e-3, weight_decay=0.0,
                      bias_correction=True):
    """The fused GaLoreAdamW step; returns (w', m', v')."""
    _one_device("galore_adamw_step", w, g, basis, m, v)
    side = side or _galore.infer_side(w.shape, basis.shape, m.shape)
    if not _kernel(g):
        c1, c2 = _galore.bias_corrections(count, b1, b2, bias_correction)
        return galore_adamw_ref(w, g, basis, m, v, c1=c1, c2=c2, side=side,
                                b1=b1, b2=b2, eps=eps, lr=lr,
                                weight_decay=weight_decay)
    return _galore.galore_adamw_step(
        w.contiguous(), _kernel_g(g), basis.float().contiguous(),
        m.float().contiguous(), v.float().contiguous(), count, side=side,
        b1=b1, b2=b2, eps=eps, lr=lr, weight_decay=weight_decay,
        bias_correction=bias_correction)


class _Rwkv6Scan(torch.autograd.Function):
    """The WKV recurrence with its backward: on a CUDA tensor the forward
    kernel in its checkpoint mode and ``rwkv6_scan_bwd``; on the CPU or
    under :func:`plain_kernels`, ``rwkv6_scan_ref`` and
    ``rwkv6_scan_bwd_ref`` (which recomputes the states from s0). The
    choice is made once, at the forward, and the backward follows it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.set_materialize_grads(False)
        ctx.kernel, ctx.has_s0 = _kernel(r), s0 is not None
        if ctx.kernel:
            y, s_final, ck = _rwkv.rwkv6_scan(r, k, v, w, u, s0, chunk=chunk,
                                              checkpoints=True)
            ctx.save_for_backward(r, k, v, w, u, ck)
        else:
            y, s_final = rwkv6_scan_ref(r, k, v, w, u, s0)
            ctx.save_for_backward(r, k, v, w, u, s0)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, start = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype)
        ds = None if ds is None else ds.float()
        if ctx.kernel:
            grads = _rwkv.rwkv6_scan_bwd(r, k, v, w, u, start,
                                         dy.contiguous(),
                                         None if ds is None
                                         else ds.contiguous())
        else:
            grads = rwkv6_scan_bwd_ref(r, k, v, w, u, start, dy, ds)
        dr, dk, dv, dw, du, ds0 = grads
        return dr, dk, dv, dw, du, ds0 if ctx.has_s0 else None, None


def rwkv6_scan(r, k, v, w, u, s0=None, *, chunk=128):
    """The RWKV6 WKV recurrence over any L — see ``kernels.rwkv6_scan``.
    r, k, v, w (B, L, H, D); u (H, D); s0 (B, H, D, D) or None. Returns
    (y in r's dtype, s_final fp32). u and s0 are taken as fp32.

    Differentiable on every device: with grad mode on and an input that
    requires grad, the call records :class:`_Rwkv6Scan` (the kernel pair
    on the card, writing the forward's checkpoints; the plain pair
    elsewhere). Otherwise it launches the forward alone, with no saved
    state, bit for bit ``rwkv6_scan_ref``."""
    _one_device("rwkv6_scan", r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        return _Rwkv6Scan.apply(
            r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
            u.float().contiguous(),
            None if s0 is None else s0.float().contiguous(), chunk)
    if not _kernel(r):
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    return _rwkv.rwkv6_scan(
        r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
        u.float().contiguous(),
        None if s0 is None else s0.float().contiguous(), chunk=chunk)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Causal GQA attention over a fresh sequence, forward only — see
    ``kernels.flash_attention``. q (B, Lq, H, D), k/v (B, Lk, Hkv, D);
    returns (B, Lq, H, D) in q's dtype.

    There is no backward (the JAX package has none either): with grad
    mode on and an input that requires grad it raises rather than return
    a result that drops the gradient."""
    _one_device("flash_attention", q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward only: an input requires grad; "
            "differentiate models.attention.attend / blockwise_attend "
            "instead (gqa_forward does so while grad is recorded)")
    if not _kernel(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale)


def nan_safe_eigh(a):
    """``torch.linalg.eigh`` of a (..., n, n) stack, except that a matrix
    with a non-finite entry gets NaN eigenpairs instead of an error — what
    LAPACK returns through JAX, so a corrupted upload propagates as NaN to
    the checks that look for it. Finite matrices are solved as they are
    (a selection, no copy of their values), so the result is bitwise
    ``torch.linalg.eigh``'s."""
    bad = ~torch.isfinite(a).all(-1).all(-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    lam, vec = torch.linalg.eigh(torch.where(bad[..., None, None], eye, a))
    return (torch.where(bad[..., None], float("nan"), lam),
            torch.where(bad[..., None, None], float("nan"), vec))


def batched_small_eigh(a, *, mask=None, force=None, sweeps=12):
    """Eigendecomposition of a batched symmetric stack ``(..., n, n)``;
    returns ``(lam, vec)`` ascending.

    Routing, as the reference's: the Jacobi kernel for CUDA tensors with
    n ≤ 64; ``torch.linalg.eigh`` (LAPACK) on the CPU, as JAX uses LAPACK
    there, and for n > 64. ``force`` pins a route for tests:
    ``"jacobi"`` (the kernel on the card, its plain version on the CPU)
    or ``"lapack"``.

    ``mask`` (bool, shaped like the batch dims) solves masked entries as
    the identity and returns their eigenvalues as exact zeros, so their
    payload never reaches the solver; an all-true mask is the unmasked
    solve.
    """
    n = a.shape[-1]
    if mask is not None:
        sel = torch.as_tensor(mask, dtype=torch.bool,
                              device=a.device)[..., None, None]
        a = torch.where(sel, a, torch.eye(n, dtype=a.dtype, device=a.device))
    use_jacobi = (force == "jacobi" or
                  (force is None and a.device.type == "cuda"
                   and n <= MAX_JACOBI_DIM))
    if not use_jacobi:
        lam, vec = nan_safe_eigh(a)
    elif _kernel(a):
        lam, vec = _eigh.jacobi_eigh(a.float(), sweeps=sweeps)
    else:
        lam, vec = jacobi_eigh_ref(a, sweeps=sweeps)
    if mask is not None:
        lam = torch.where(torch.as_tensor(mask, dtype=torch.bool,
                                          device=a.device)[..., None],
                          lam, torch.zeros((), dtype=lam.dtype,
                                           device=lam.device))
    return lam, vec
