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
(``chip_smoke.py``); here its route rules (every call of the ported paths
on ``tc``, fp32 and layouts a tensor map does not describe on ``simt``)
and its tile plan are checked: the grid runs every (query tile, batch
row, q head) once, and each query tile's key-tile range holds every key
its rows attend, as ``chip_smoke.flash_pairs`` counts them.
"""
import functools
import importlib.util
import sys
from pathlib import Path

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

# the kernel module (``repro_torch.kernels.flash_attention`` the attribute
# is ops' dispatching function)
tfa = sys.modules["repro_torch.kernels.flash_attention"]

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
    assert sum(fkernel.routes.values()) == 0


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
    assert mod.flash_attention.launches == 0
    assert sum(mod.flash_attention.routes.values()) == 0


# (B, Lq, Lk, H, Hkv, D, window) of every call the ported paths make
# (chip_smoke.py FLASH_PATH): qwen1.5-0.5b admission and generate
# prefills, starcoder2-7b's, its ragged 100-token admission and its
# 8192-token long prefill.
FLASH_PATH = [(1, 128, 128, 16, 16, 64, 0), (8, 128, 128, 16, 16, 64, 0),
              (1, 128, 128, 36, 4, 128, 4096),
              (1, 100, 100, 36, 4, 128, 4096),
              (8, 128, 128, 36, 4, 128, 4096),
              (1, 8192, 8192, 36, 4, 128, 4096)]
SMS = 132      # an H100's multiprocessors


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("shape", FLASH_PATH,
                         ids=lambda c: "-".join(map(str, c)))
def test_route_of_every_path_call_is_tc(shape):
    """Every call the ported paths make is bf16 with contiguous q, k, v:
    the tensor-core route."""
    b, lq, lk, h, hkv, d, window = shape
    q, k, v = _bf16(b, lq, h, d), _bf16(b, lk, hkv, d), _bf16(b, lk, hkv, d)
    assert tfa.route(q, k, v, True, window) == "tc"


def test_route_of_gqa_forward_layouts_is_tc(monkeypatch):
    """The q, k, v that ``gqa_forward`` hands to the kernel (heads split
    by a reshape, RoPE applied) take the tc route in bf16, one kv head
    included."""
    seen = []
    monkeypatch.setattr(tops, "flash_attention", lambda q, k, v, **kw: (
        seen.append(tfa.route(q, k, v, **kw)), q)[1])
    rng = np.random.default_rng(13)
    for hkv in (2, 1):
        p = {n: torch.from_numpy(a).to(torch.bfloat16)
             for n, a in _gqa_params(rng, 256, 4, hkv, 64).items()}
        x = torch.from_numpy(rng.standard_normal((2, 24, 256)).astype(
            np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            tattn.gqa_forward(p, x, torch.arange(24), n_heads=4, n_kv=hkv,
                              head_dim=64, window=16)
    assert seen == ["tc", "tc"]


def _misaligned(*shape):
    """bf16 values whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    view = torch.empty(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)
    assert view.data_ptr() % 16 == 2
    return view


@pytest.mark.parametrize("case,want", [
    ("contiguous", "tc"),
    ("strided_q", "tc"),             # every other head of a wider tensor
    ("one_kv_head", "tc"),           # size-1 dims read at index 0 only
    ("fp32", "simt"),                # TF32 wgmma cannot hold 1e-5
    ("misaligned_q", "simt"),        # base pointer 2 B off
    ("misaligned_v", "simt"),
    ("row_stride_off_16", "simt"),   # head stride 68 elements = 136 B
    ("heads_outside_sequence", "simt"),   # a (B, H, L, D) transpose
    ("no_keys", "simt"),             # Lk = 0: no tensor map of size 0
])
def test_route_rules(case, want):
    """The route follows the dtype, Lk and whether a 4-D tensor map over
    (D, H, L, B) describes each operand: 16-byte aligned base pointer and
    strides, strides nested as in (B, L, H, D)."""
    b, lq, lk, h, hkv, d = 2, 40, 40, 4, 2, 64
    q, k, v = _bf16(b, lq, h, d), _bf16(b, lk, hkv, d), _bf16(b, lk, hkv, d)
    if case == "strided_q":
        q = _bf16(b, lq, 2 * h, d)[:, :, ::2]
    elif case == "one_kv_head":
        q = _bf16(1, lq, h, d)
        k = v = _bf16(1, lk, 3, d)[:, :, 1:2]    # head stride 64, size 1
    elif case == "fp32":
        q, k, v = (t.float() for t in (q, k, v))
    elif case == "misaligned_q":
        q = _misaligned(b, lq, h, d)
    elif case == "misaligned_v":
        v = _misaligned(b, lk, hkv, d)
    elif case == "row_stride_off_16":
        q = _bf16(b, lq, h, d + 4)[..., :d]
    elif case == "heads_outside_sequence":
        q = _bf16(b, h, lq, d).transpose(1, 2)
    elif case == "no_keys":
        k, v = _bf16(b, 0, hkv, d), _bf16(b, 0, hkv, d)
    assert tfa.route(q, k, v) == want


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The card script, for its count of attended pairs (``flash_pairs``,
    what its bounds are computed from)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan_cases():
    cases = [(b, lq, lk, h, hkv, w) for b, lq, lk, h, hkv, _, w in FLASH_PATH]
    cases += [(2, 100, 300, 8, 2, 128), (2, 150, 70, 8, 2, 0),
              (1, 150, 70, 4, 2, 40), (2, 200, 200, 6, 2, 20),
              (1, 1, 300, 4, 1, 0), (1, 63, 63, 4, 2, 0),
              (1, 65, 200, 4, 2, 1), (2, 300, 300, 4, 2, 127),
              (2, 300, 300, 4, 2, 129), (1, 1000, 1000, 36, 4, 300)]
    return cases


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", _plan_cases(),
                         ids=lambda c: "-".join(map(str, c)))
def test_plan_covers_every_tile_and_attended_key(case, causal):
    """On both routes: the grid runs every (query tile, batch row, q head)
    once, the q heads of one kv head side by side and the query tiles
    from the last to the first; each query tile's key-tile range holds
    every key its rows attend (the attended pairs inside the ranges add up
    to ``flash_pairs``' count), every key when a row sees none, and no
    tile without an attended key."""
    b, lq, lk, h, hkv, window = case
    if not causal:
        window = 0
    for which in tfa.ROUTES:
        p = tfa.plan(which, b, lq, h, SMS)
        assert p.route == which and p.q_tiles * p.bq >= lq > \
            (p.q_tiles - 1) * p.bq
        order = tfa.block_order(p, b, h, hkv)
        assert len(order) == p.blocks == len(set(order)) == \
            p.q_tiles * b * h
        groups = h // hkv
        for i in range(0, len(order), groups):   # one kv head's q heads
            run = order[i:i + groups]
            assert len({(t, bb, hh // groups) for t, bb, hh in run}) == 1
        tiles = [t for t, _, _ in order]
        assert tiles == sorted(tiles, reverse=True)
        attended = 0
        nkt = -(-lk // p.bk)
        for qt in range(p.q_tiles):
            begin, end = tfa.key_tiles(p, qt, lq, lk, causal, window)
            assert 0 <= begin < end <= nkt
            pos = np.arange(qt * p.bq, min(lq, (qt + 1) * p.bq)) + lk - lq
            if not causal:
                lo, hi = np.zeros_like(pos), np.full_like(pos, lk - 1)
            else:
                lo = np.maximum(pos - window + 1, 0) if window else \
                    np.zeros_like(pos)
                hi = pos
            if causal and pos.min() < 0:      # a row that sees no key
                assert (begin, end) == (0, nkt)
            k0, k1 = begin * p.bk, min(end * p.bk, lk) - 1
            attended += int(np.clip(np.minimum(hi, k1) - np.maximum(lo, k0)
                                    + 1, 0, None).sum())
            if not (causal and pos.min() < 0):
                for kt in range(begin, end):     # each tile earns its visit
                    a, z = kt * p.bk, min(lk, (kt + 1) * p.bk) - 1
                    assert ((np.minimum(hi, z) >= np.maximum(lo, a))).any()
        assert attended == _chip_smoke().flash_pairs(lq, lk, causal, window)


def test_block_counts_fill_the_card():
    """128-row query tiles where they give the card a block per SM (the
    long prefill), 64-row tiles where they would not (a 128-token
    starcoder2-7b prompt: 36 blocks at 128 rows, 72 at 64)."""
    assert tfa.plan("tc", 1, 8192, 36, SMS).bq == 128
    p = tfa.plan("tc", 1, 128, 36, SMS)
    assert p.bq == 64 and p.blocks >= 72
    assert tfa.plan("tc", 8, 128, 36, SMS).bq == 128     # 288 blocks
    assert tfa.plan("tc", 8, 128, 16, SMS).bq == 64      # 128 < 132
