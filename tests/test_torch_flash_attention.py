"""Port parity for flash attention: the port's ``flash_attention_ref`` (what
``ops.flash_attention`` runs on the CPU) against the JAX package's
``ref.flash_attention_ref``, and ``gqa_forward`` with no autograd graph
(the route to the kernel) against JAX ``gqa_forward``, on the same numpy
inputs.

The oracle is the JAX reference, not the Pallas kernel: the kernel calls
``pl.load``, which the installed jax lacks (ROADMAP Queue 3 a). Tolerances:
fp32 within 2e-6 of the output scale — the port multiplies the scores by
a Python-float 1/√D where JAX divides by a float32 √D, and sums in
another order; bf16 within one bf16 ulp of the output scale, since the
fp32 result is rounded once and a last-place difference can cross a
rounding boundary. ``gqa_forward`` within 1e-5 of scale on both JAX
branches (``attend``; ``blockwise_attend`` at ``attn_chunk`` 32 with a
window of 16 at L = 64). The CUDA kernel itself runs only on the card
(``chip_smoke.py``).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention as fkernel
from repro_torch.models import attention as tattn

FP32_TOL = 2e-6          # of the output scale
GQA_TOL = 1e-5

# (B, Lq, Lk, Hkv, groups, D, causal, window)
CASES = [
    (2, 16, 16, 2, 1, 64, True, 0),       # MHA, Lq = Lk
    (2, 16, 16, 2, 4, 64, True, 5),       # window
    (1, 13, 13, 1, 9, 128, True, 4),      # ragged L, 9 groups, D 128
    (2, 7, 19, 2, 4, 64, True, 0),        # Lq < Lk, suffix-aligned
    (1, 7, 19, 1, 9, 128, True, 6),       # Lq < Lk with a window
    (2, 19, 7, 2, 4, 64, True, 0),        # Lq > Lk: queries with no key
    (1, 19, 7, 1, 9, 128, True, 3),       # Lq > Lk with a window
    (2, 11, 17, 2, 4, 64, False, 0),      # not causal
]


def _ulp_bf16(v):
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _inputs(seed, b, lq, lk, hkv, groups, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, hkv * groups, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ref_matches_jax(case, dtype):
    b, lq, lk, hkv, groups, d, causal, window = case
    q, k, v = _inputs(sum(case[:6]), b, lq, lk, hkv, groups, d)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jref.flash_attention_ref(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
        window=window)
    got = tops.flash_attention(*(torch.from_numpy(x).to(tdt)
                                 for x in (q, k, v)),
                               causal=causal, window=window)
    assert got.dtype == tdt and got.shape == q.shape
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    tol = FP32_TOL * scale if dtype == "float32" else _ulp_bf16(scale)
    assert np.abs(got.float().numpy() - want).max() <= tol


def test_no_key_rows_average_v_uniformly():
    """Lq > Lk: the first Lq − Lk queries see no key and get the mean of
    V, as both JAX versions give (finite −1e30, not −inf)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 9, 4, 1, 2, 64))
    out = tops.flash_attention(q, k, v, causal=True)
    mean = v.mean(dim=1, keepdim=True).expand(1, 5, 2, 64)
    assert torch.isfinite(out).all()
    assert torch.allclose(out[:, :5], mean, atol=1e-6)


def test_ref_row_chunks_change_nothing(monkeypatch):
    """The plain version chunks the query rows to bound its score tensor;
    each row's softmax is its own, so the result does not move."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 37, 37, 2, 3, 64))
    whole = tref.flash_attention_ref(q, k, v, window=9)
    monkeypatch.setattr(tref, "FLASH_REF_SCORES", 2 * 6 * 37 * 5)
    chunked = tref.flash_attention_ref(q, k, v, window=9)
    assert (chunked - whole).abs().max() <= 1e-6 * whole.abs().max()


def _gqa_params(rng, d, h, hkv, hd):
    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)
    return {"wq": w(d, h * hd), "wk": w(d, hkv * hd), "wv": w(d, hkv * hd),
            "wo": w(h * hd, d), "bq": w(h * hd), "bk": w(hkv * hd),
            "bv": w(hkv * hd)}


@pytest.mark.parametrize("l, window, attn_chunk", [(24, 0, 0), (24, 8, 0),
                                                   (64, 16, 32)],
                         ids=["attend", "attend-window", "blockwise"])
def test_gqa_forward_no_grad_matches_jax(monkeypatch, l, window, attn_chunk):
    """With no graph recorded, gqa_forward goes through
    ``kernels.ops.flash_attention`` once (causal, the config's window) and
    agrees with the JAX function, whichever branch JAX takes."""
    rng = np.random.default_rng(l + window)
    d, h, hkv, hd = 32, 6, 2, 16
    p = _gqa_params(rng, d, h, hkv, hd)
    x = rng.standard_normal((2, l, d)).astype(np.float32)
    pos = np.arange(l, dtype=np.int32)
    kw = dict(n_heads=h, n_kv=hkv, head_dim=hd, rope_theta=1e4,
              window=window, attn_chunk=attn_chunk)
    jout, (jk, jv) = jattn.gqa_forward(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), **kw)
    calls = []
    orig = tops.flash_attention

    def spy(q, k, v, **fkw):
        calls.append(fkw)
        return orig(q, k, v, **fkw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    with torch.no_grad():
        tout, (tk, tv) = tattn.gqa_forward(
            {n: torch.from_numpy(a) for n, a in p.items()},
            torch.from_numpy(x), torch.from_numpy(pos), **kw)
    assert calls == [{"causal": True, "window": window}]
    want = np.asarray(jout)
    assert np.abs(tout.numpy() - want).max() <= GQA_TOL * np.abs(want).max()
    assert np.abs(tk.numpy() - np.asarray(jk)).max() <= GQA_TOL


def test_gqa_forward_keeps_attend_while_grad_is_recorded(monkeypatch):
    """The training read differentiates attend / blockwise_attend, never
    the forward-only flash path, and its gradient flows."""
    calls = []
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: calls.append(kw))
    rng = np.random.default_rng(9)
    p = {n: torch.from_numpy(a).requires_grad_()
         for n, a in _gqa_params(rng, 32, 6, 2, 16).items()}
    x = torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32))
    for chunk in (0, 32):
        out, _ = tattn.gqa_forward(p, x, torch.arange(64), n_heads=6,
                                   n_kv=2, head_dim=16, window=16,
                                   attn_chunk=chunk)
        out.square().sum().backward()
    assert calls == [] and p["wq"].grad is not None


def test_refusals():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 8, 1, 2, 64))
    # forward only: no silent drop of a gradient
    with pytest.raises(RuntimeError, match="forward only"):
        tops.flash_attention(q.clone().requires_grad_(), k, v)
    with torch.no_grad():
        tops.flash_attention(q.clone().requires_grad_(), k, v)
    # a window without the causal mask: the JAX versions disagree
    for fn in (tops.flash_attention, tref.flash_attention_ref):
        with pytest.raises(ValueError, match="Queue 3 item m"):
            fn(q, k, v, causal=False, window=4)
    # mixed devices
    with pytest.raises(ValueError, match="mixed devices"):
        tops.flash_attention(q, k.to("meta"), v)
    # heads that do not group
    with pytest.raises(ValueError, match="multiple of Hkv"):
        kv2 = torch.zeros(1, 4, 2, 64)
        tops.flash_attention(torch.zeros(1, 4, 3, 64), kv2, kv2)
    # the CUDA wrapper launches or raises: CPU tensors, other head sizes
    with pytest.raises(ValueError, match="CUDA device"):
        fkernel(q, k, v)
    odd = torch.from_numpy(rng.standard_normal((1, 4, 2, 40)).astype(
        np.float32))
    with pytest.raises(ValueError, match="head sizes"):
        fkernel(odd, odd, odd)
    assert fkernel.launches == 0


def test_cuda_module_imports_without_nvcc(monkeypatch):
    """Importing the kernel module builds nothing; the first launch builds,
    and without the CUDA toolkit that raises instead of running
    anything else."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "_LIBS", {})
    import importlib
    mod = importlib.import_module("repro_torch.kernels.flash_attention")
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mod._lib()
