"""Port parity: ``repro_torch.models`` layers and GQA attention, and the
pytree helper, against the JAX package on the same numpy inputs.

fp32 throughout, held to 1e-5; the KV cache is bf16 in both packages, so
cache contents are compared after the same rounding.
"""
from typing import NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree

TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 64), _rand(rng, 64)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_rope(per_slot):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 1 if per_slot else 7, 4, 32)
    pos = (np.array([[5], [0], [130]], np.int32) if per_slot
           else np.arange(7, dtype=np.int32) + 11)
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


def test_attend_causal():
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 9, 4, 16), _rand(rng, 2, 9, 2, 16), \
        _rand(rng, 2, 9, 2, 16)
    pos = np.arange(9, dtype=np.int32)
    tmask = tattn.causal_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                              window=4)[None]
    jmask = jattn.causal_mask(jnp.asarray(pos), jnp.asarray(pos),
                              window=4)[None]
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    _close(tattn.attend(*map(torch.from_numpy, (q, k, v)), tmask),
           jattn.attend(*map(jnp.asarray, (q, k, v)), jmask))


@pytest.mark.parametrize("window", [0, 6])
def test_blockwise_attend(window):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 16, 4, 8), _rand(rng, 2, 16, 2, 8), \
        _rand(rng, 2, 16, 2, 8)
    _close(tattn.blockwise_attend(*map(torch.from_numpy, (q, k, v)),
                                  window=window, chunk_q=4, chunk_k=4),
           jattn.blockwise_attend(*map(jnp.asarray, (q, k, v)),
                                  window=window, chunk_q=4, chunk_k=4))


@pytest.mark.parametrize("per_row", [False, True])
def test_kv_cache_write(per_row):
    rng = np.random.default_rng(4)
    b, size, hkv, hd = 3, 6, 2, 8
    ln = 1 if per_row else 4
    k_new, v_new = _rand(rng, b, ln, hkv, hd), _rand(rng, b, ln, hkv, hd)
    t0 = np.array([0, 5, 9], np.int32) if per_row else 4   # 9, 4+: wrap
    jc = jattn.kv_cache_write(jattn.kv_cache_init(b, size, hkv, hd),
                              jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(t0))
    tc = tattn.kv_cache_write(tattn.kv_cache_init(b, size, hkv, hd),
                              torch.from_numpy(k_new),
                              torch.from_numpy(v_new),
                              torch.as_tensor(t0))
    assert tc.k.dtype == torch.bfloat16
    for tf, jf in zip(tc, jc):
        assert np.array_equal(_np(tf), _np(jf))


@pytest.mark.parametrize("per_row", [False, True])
def test_gqa_decode(per_row):
    rng = np.random.default_rng(5)
    b, d, h, hkv, hd, size = 3, 32, 4, 2, 8, 8
    p = {"wq": _rand(rng, d, h * hd, scale=0.2),
         "wk": _rand(rng, d, hkv * hd, scale=0.2),
         "wv": _rand(rng, d, hkv * hd, scale=0.2),
         "wo": _rand(rng, h * hd, d, scale=0.2),
         "bq": _rand(rng, h * hd), "bk": _rand(rng, hkv * hd),
         "bv": _rand(rng, hkv * hd)}
    x = _rand(rng, b, 1, d)
    # a cache holding 5 earlier tokens per row
    ck, cv = _rand(rng, b, size, hkv, hd), _rand(rng, b, size, hkv, hd)
    cpos = np.where(np.arange(size) < 5, np.arange(size), -1)
    cpos = np.broadcast_to(cpos, (b, size)).astype(np.int32).copy()
    t = np.array([5, 5, 5], np.int32) if per_row else 5
    kw = dict(n_heads=h, n_kv=hkv, head_dim=hd, rope_theta=1e4)
    jcache = jattn.KVCache(k=jnp.asarray(ck, jnp.bfloat16),
                           v=jnp.asarray(cv, jnp.bfloat16),
                           pos=jnp.asarray(cpos))
    jout, jc = jattn.gqa_decode({k_: jnp.asarray(v_) for k_, v_ in p.items()},
                                jnp.asarray(x), jcache, jnp.asarray(t), **kw)
    tcache = tattn.KVCache(k=torch.from_numpy(ck).to(torch.bfloat16),
                           v=torch.from_numpy(cv).to(torch.bfloat16),
                           pos=torch.from_numpy(cpos))
    tout, tc = tattn.gqa_decode({k_: torch.from_numpy(v_)
                                 for k_, v_ in p.items()},
                                torch.from_numpy(x), tcache,
                                torch.as_tensor(t), **kw)
    _close(tout, jout)
    for tf, jf in zip(tc, jc):
        assert np.array_equal(_np(tf), _np(jf))


class _Pair(NamedTuple):
    w: object
    b: object


def test_tree_flatten_order_and_paths_match_jax():
    t = {"z": [1, {"y": 2, "x": None}], "a": _Pair(3, 4), "m": (5, None)}
    jl = jax.tree_util.tree_flatten_with_path(t)[0]
    tl, tdef = tree.tree_flatten_with_path(t)
    assert [leaf for _, leaf in tl] == [leaf for _, leaf in jl]
    jpaths = ["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path) for path, _ in jl]
    assert [tree.path_str(p) for p, _ in tl] == jpaths
    rebuilt = tdef.unflatten([10 * v for _, v in tl])
    assert rebuilt == jax.tree_util.tree_map(lambda v: 10 * v, t)
    assert tree.tree_map(lambda f, s: s if f is None else f,
                         {"a": None, "b": 1}, {"a": _Pair(7, 8), "b": None},
                         is_leaf=lambda v: v is None) == \
        {"a": _Pair(7, 8), "b": 1}


def test_tree_flatten_leaves_no_reference_cycle():
    """Flattening leaves no reference cycle behind: a dropped tree's
    leaves are freed at once, not at the next garbage collection (a
    served model's weights would otherwise outlive it on the card)."""
    import gc
    import weakref
    leaf = torch.zeros(3)
    alive = weakref.ref(leaf)
    t = {"a": [leaf, None], "b": _Pair(1, 2)}
    gc.disable()
    try:
        tree.tree_leaves(t)
        tree.tree_flatten_with_path(t, is_leaf=lambda x: x is None)
        tree.tree_map(lambda x: x, t)
        del t, leaf
        assert alive() is None
    finally:
        gc.enable()


def test_params_from_jax_keeps_bf16_bits():
    rng = np.random.default_rng(6)
    w = jnp.asarray(_rand(rng, 4, 6), jnp.bfloat16)
    ad = jlayers.MultiAdapterDelta(w=w, bases=jnp.ones((2, 6, 3)),
                                   rts=jnp.ones((2, 4, 3)),
                                   scales=jnp.ones((2,)))
    out = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"blocks": [{"wq": ad}], "n": jnp.ones(3)}), "cpu")
    leaf = out["blocks"][0]["wq"]
    assert isinstance(leaf, tlayers.MultiAdapterDelta)
    assert leaf.w.dtype == torch.bfloat16 and leaf.bases.dtype == torch.float32
    assert np.array_equal(leaf.w.float().numpy(), _np(w))
    assert out["n"].dtype == torch.float32
