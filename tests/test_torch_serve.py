"""Port parity for the serving slice: qwen1.5-0.5b and starcoder2-7b
(smoke variants, fp32, 2 layers, d 256; starcoder2's with LayerNorm, the
plain GELU MLP, an untied lm_head and a 64-token window) with
heterogeneous adapters, JAX package vs ``repro_torch`` on the CPU. Every
test of the ``slice_`` fixture runs for both configurations, and one GQA
case (starcoder2 with a single kv head, a 96-token prompt over its window)
runs the windowed prefill through the flash route, once over a cache that
holds the prompt and once over a ring of the window's 64 slots, the
layout the reference prescribes; ``kv_cache_write`` itself is held to
JAX's for a write longer than its ring on both ``t0`` branches.

The JAX params come from ``repro.models.model.init_params``, wrapped by
the JAX ``AdapterStore`` and carried across with ``params_from_jax``.
Prefill logits agree to 1e-5; decode logits to 1e-4, since the bf16 KV
cache rounds on both sides; greedy tokens and ``SlotServer`` outputs are
identical. Also: the port's ``AdapterStore`` tables equal the JAX ones bit
for bit, the port imports neither ``jax`` nor ``repro``, and its entry
points refuse to run on the CPU unless asked.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.launch import adapters as jadapters
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import adapters as tadapters
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from repro_torch.utils import tree

ARCH = "qwen1.5-0.5b"
ARCHS = ["qwen1.5-0.5b", "starcoder2-7b"]
G = 3


# Decode logits from each package's own bf16 cache, where one-ulp flips of
# a few cache entries move them: qwen1.5-0.5b reads 7e-7 and keeps the
# 1e-4 it always had; starcoder2-7b reads 1.1e-4 (20 of 49,152 entries a
# bf16 step apart).
DECODE_OWN_CACHE_TOL = {"qwen1.5-0.5b": 1e-4, "starcoder2-7b": 3e-4}


def _n_targets(cfg):
    """Adapted projections per layer: wq wk wv wo and the MLP's (w_gate
    w_up w_down for the GLU MLP, w_up w_down for the plain one)."""
    return 4 + (3 if cfg.mlp_kind == "glu" else 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size tensors gain nothing from torch's intra-op pool, and
    beside the JAX compiles of parallel test workers its idle threads only
    compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def slice_(request):
    """(jax cfg, torch cfg, jax base params, jax served, torch served,
    factors) for G random tenants, for each of ``ARCHS``."""
    jcfg = jsmoke(jget_config(request.param))
    tcfg = smoke_variant(get_config(request.param))
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    store = jadapters.AdapterStore(params, jadapters.serving_target_fn(jcfg),
                                   G, 3)
    rng = np.random.default_rng(7)
    factors = []
    for i in range(G):
        basis, rt = store.random_factors(rng, rt_scale=0.05)
        store.put(i, rt, basis, scale=1.0 - 0.01 * i)
        factors.append((basis, rt, 1.0 - 0.01 * i))
    served = store.wrap(params)
    tserved = params_from_jax(jax.tree_util.tree_map(np.asarray, served),
                              "cpu")
    return jcfg, tcfg, params, served, tserved, factors


def _prompts(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    j, t = jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd == td
    assert t.param_dtype == torch.float32
    assert get_config(arch).param_dtype == torch.bfloat16
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


def test_prefill_and_decode_logits(slice_):
    """Prefill logits to 1e-5. Both packages round K and V into a bf16
    cache, and an fp32 last-place difference upstream can flip an entry
    by a bf16 ulp: the caches are held to one bf16 ulp of their scale,
    the decode step from JAX's own cache to 1e-4, and the decode step
    from the port's cache to ``DECODE_OWN_CACHE_TOL`` of its arch
    (ROADMAP Queue 3 item n)."""
    jcfg, tcfg, _, served, tserved, _ = slice_
    prompts = _prompts(1, (G, 8), jcfg.vocab_size)
    ids = np.array([2, 0, 1], np.int32)
    jstate = jmodel.init_decode_state(jcfg, G, 16)
    with jlayers.adapter_ids(jnp.asarray(ids)):
        jl, jstate = jmodel.prefill(served, jcfg, jnp.asarray(prompts),
                                    jstate)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl2, _ = jmodel.decode_step(served, jcfg, jtok, jstate)
    tok = torch.from_numpy(np.array(jtok))
    with torch.inference_mode():
        tstate = tmodel.init_decode_state(tcfg, G, 16, device="cpu")
        with tlayers.adapter_ids(torch.from_numpy(ids)):
            tl, tstate = tmodel.prefill(tserved, tcfg,
                                        torch.from_numpy(prompts), tstate)
            assert int(tstate.t) == 8 and tstate.t.ndim == 0
            caches = [(c.k.clone(), c.v.clone()) for c in tstate.layers]
            tl2, tstate = tmodel.decode_step(tserved, tcfg, tok, tstate)
            from_jax = decode_state_from_jax(
                jax.tree_util.tree_map(np.asarray, jstate), "cpu")
            tl2_same, _ = tmodel.decode_step(tserved, tcfg, tok, from_jax)
    assert tl.dtype == torch.float32 and tl.shape == (G, jcfg.vocab_size)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-5
    for (tk, tv), jc in zip(caches, jstate.layers):
        for got, want in ((tk, jc.k), (tv, jc.v)):
            got = got.float().numpy()
            want = np.asarray(want.astype(jnp.float32))
            ulp = np.exp2(np.floor(np.log2(np.abs(want).max())) - 7)
            assert np.abs(got - want).max() <= ulp
    assert np.max(np.abs(tl2_same.numpy() - np.asarray(jl2))) <= 1e-4
    assert np.max(np.abs(tl2.numpy() - np.asarray(jl2))) <= \
        DECODE_OWN_CACHE_TOL[jcfg.name.removesuffix("-smoke")]


def test_gqa_window_prefill_and_decode_match_jax():
    """starcoder2's smoke variant with one kv head (4 q heads per kv head)
    and a 96-token prompt over its 64-token window: prefill logits (the
    flash route, window acting), decode logits and greedy tokens agree
    with the JAX package."""
    jcfg = dataclasses.replace(jsmoke(jget_config("starcoder2-7b")),
                               n_kv_heads=1)
    tcfg = dataclasses.replace(smoke_variant(get_config("starcoder2-7b")),
                               n_kv_heads=1)
    assert tcfg.sliding_window == 64 and tcfg.n_heads == 4
    params = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    prompts = _prompts(11, (2, 96), jcfg.vocab_size)
    jstate = jmodel.init_decode_state(jcfg, 2, 104)
    jl, jstate = jmodel.prefill(params, jcfg, jnp.asarray(prompts), jstate)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    jl2, _ = jmodel.decode_step(params, jcfg, jtok, jstate)
    with torch.inference_mode():
        tstate = tmodel.init_decode_state(tcfg, 2, 104, device="cpu")
        tl, tstate = tmodel.prefill(tparams, tcfg, torch.from_numpy(prompts),
                                    tstate)
        tl2, _ = tmodel.decode_step(
            tparams, tcfg, torch.from_numpy(np.asarray(jtok)), tstate)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-5
    assert np.max(np.abs(tl2.numpy() - np.asarray(jl2))) <= 1e-4
    want = np.asarray(jserve.generate(params, jcfg, jnp.asarray(prompts), 4,
                                      104))
    got = tserve.generate(tparams, tcfg, prompts, 4, 104, device="cpu")
    assert np.array_equal(got.numpy(), want)


class _NoRepeatedScatter(TorchDispatchMode):
    """Fails on an ``index_put_`` whose indices name one position twice:
    torch leaves the winner of a repeated index undefined (it changes with
    the thread count on the CPU and is unordered on the card), so a ring
    write must never send one (ROADMAP Queue 3 p)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.index_put_.default,
                    torch.ops.aten.index_put.default):
            idx = torch.broadcast_tensors(*(i for i in args[1]
                                            if i is not None))
            flat = torch.stack([i.reshape(-1) for i in idx], 1)
            assert torch.unique(flat, dim=0).shape[0] == flat.shape[0], \
                f"index_put_ with repeated indices ({flat.shape[0]} writes)"
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_ring_write_longer_than_cache_matches_jax(per_row):
    """A write of more positions than the ring has slots (a prompt over a
    windowed cache) leaves the k, v and pos that JAX's ``kv_cache_write``
    leaves, on both ``t0`` branches, with no repeated index in any scatter
    and at a size the CPU splits across threads."""
    rng = np.random.default_rng(21 + per_row)
    b, ln, size, h, d = 2, 600, 64, 4, 64
    k, v = (rng.standard_normal((b, ln, h, d)).astype(np.float32)
            for _ in range(2))
    t0 = np.array([0, 37], np.int32) if per_row else 5
    want = jattn.kv_cache_write(
        jattn.kv_cache_init(b, size, h, d, jnp.float32), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(t0))
    got = tattn.kv_cache_init(b, size, h, d, torch.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with torch.inference_mode(), _NoRepeatedScatter():
            tattn.kv_cache_write(got, torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(t0) if per_row else t0)
    finally:
        torch.set_num_threads(n)
    for name, g, w in zip(("k", "v", "pos"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


def test_gqa_window_ring_cache_matches_jax():
    """The layout the reference prescribes for a sliding-window arch: a
    cache of the window's 64 slots under a 96-token prompt
    (``init_decode_state(..., 64)``, starcoder2's smoke variant with one
    kv head). Decode logits agree with JAX's to the starcoder2 decode
    tolerance of ``test_prefill_and_decode_logits`` (Queue 3 n) and greedy
    tokens are equal; no scatter repeats an index."""
    jcfg = dataclasses.replace(jsmoke(jget_config("starcoder2-7b")),
                               n_kv_heads=1)
    tcfg = dataclasses.replace(smoke_variant(get_config("starcoder2-7b")),
                               n_kv_heads=1)
    assert tcfg.sliding_window == 64
    params = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    prompts = _prompts(11, (2, 96), jcfg.vocab_size)
    jstate = jmodel.init_decode_state(jcfg, 2, 64)
    jl, jstate = jmodel.prefill(params, jcfg, jnp.asarray(prompts), jstate)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    jl2, _ = jmodel.decode_step(params, jcfg, jtok, jstate)
    with torch.inference_mode(), _NoRepeatedScatter():
        tstate = tmodel.init_decode_state(tcfg, 2, 64, device="cpu")
        tl, tstate = tmodel.prefill(tparams, tcfg, torch.from_numpy(prompts),
                                    tstate)
        tl2, _ = tmodel.decode_step(
            tparams, tcfg, torch.from_numpy(np.array(jtok)), tstate)
        got = tserve.generate(tparams, tcfg, prompts, 4, 64, device="cpu")
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= 1e-5
    assert np.max(np.abs(tl2.numpy() - np.asarray(jl2))) <= \
        DECODE_OWN_CACHE_TOL["starcoder2-7b"]
    want = np.asarray(jserve.generate(params, jcfg, jnp.asarray(prompts), 4,
                                      64))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("scan", [False, True])
def test_greedy_generate_matches_jax(slice_, scan):
    jcfg, tcfg, _, served, tserved, _ = slice_
    prompts = _prompts(2, (G, 8), jcfg.vocab_size)
    ids = np.array([2, 0, 1], np.int32)
    want = np.asarray((jserve.generate_scan if scan else jserve.generate)(
        served, jcfg, jnp.asarray(prompts), 5, 16, adapters=jnp.asarray(ids)))
    got = (tserve.generate_scan if scan else tserve.generate)(
        tserved, tcfg, prompts, 5, 16, adapters=ids, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_per_slot_positions_match_scalar(slice_):
    """decode_step with a (B,) t vector (all equal) matches the scalar-t
    path bit for bit."""
    _, tcfg, _, _, tserved, _ = slice_
    prompts = torch.from_numpy(_prompts(3, (G, 6), tcfg.vocab_size))
    ids = torch.tensor([1, 1, 0], dtype=torch.int32)
    with torch.inference_mode(), tlayers.adapter_ids(ids):
        out = []
        for per_slot in (False, True):
            st = tmodel.init_decode_state(tcfg, G, 12, device="cpu")
            logits, st = tmodel.prefill(tserved, tcfg, prompts, st)
            if per_slot:
                st = tmodel.DecodeState(t=st.t.expand(G).contiguous(),
                                        layers=st.layers)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tmodel.decode_step(tserved, tcfg, tok, st)[0])
    assert torch.equal(out[0], out[1])


def test_slot_server_matches_jax(slice_):
    """Oversubscribed requests with mixed prompt lengths, budgets and
    adapters through retire+admit: the port's per-request outputs equal
    the JAX SlotServer's."""
    jcfg, tcfg, _, served, tserved, _ = slice_
    rng = np.random.default_rng(4)
    spec = [(rng.integers(0, jcfg.vocab_size, 8 if i % 2 else 6),
             5 if i % 3 else 3, i % G) for i in range(5)]
    jsrv = jserve.SlotServer(served, jcfg, slots=2, cache_len=16, segment=2)
    jout = jsrv.run([jserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
                     for i, (p, n, a) in enumerate(spec)])
    tsrv = tserve.SlotServer(tserved, tcfg, slots=2, cache_len=16, segment=2,
                             device="cpu")
    tout = tsrv.run([tserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
                     for i, (p, n, a) in enumerate(spec)])
    assert tout["outputs"] == jout["outputs"]
    assert tout["stats"]["admitted"] == 5
    assert not tsrv.active.any() and not tsrv.queue


TEMP = 0.8


@pytest.mark.parametrize("scan", [False, True])
def test_sampled_generate_matches_jax(slice_, scan):
    """At temperature 0.8 the port draws JAX's tokens: the first with
    ``PRNGKey(seed)`` itself, then split before each step (``generate``)
    or ``fold_in(key, i)`` at step i (``generate_scan``)."""
    jcfg, tcfg, _, served, tserved, _ = slice_
    prompts = _prompts(2, (G, 8), jcfg.vocab_size)
    ids = np.array([2, 0, 1], np.int32)
    fn = "generate_scan" if scan else "generate"
    want = np.asarray(getattr(jserve, fn)(
        served, jcfg, jnp.asarray(prompts), 6, 16, temperature=TEMP,
        key=jax.random.PRNGKey(5), adapters=jnp.asarray(ids)))
    got = getattr(tserve, fn)(tserved, tcfg, prompts, 6, 16,
                              temperature=TEMP, seed=5, adapters=ids,
                              device="cpu")
    greedy = getattr(tserve, fn)(tserved, tcfg, prompts, 6, 16,
                                 adapters=ids, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert not torch.equal(got, greedy)       # the draw is not the argmax


def test_sampled_slot_server_matches_jax(slice_):
    """Sampled continuous batching: a split per admission, ``fold_in(key,
    base + i)`` within a segment, through retire + admit."""
    jcfg, tcfg, _, served, tserved, _ = slice_
    rng = np.random.default_rng(4)
    spec = [(rng.integers(0, jcfg.vocab_size, 8 if i % 2 else 6),
             5 if i % 3 else 3, i % G) for i in range(5)]
    jsrv = jserve.SlotServer(served, jcfg, slots=2, cache_len=16, segment=2,
                             temperature=TEMP, seed=3)
    jout = jsrv.run([jserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
                     for i, (p, n, a) in enumerate(spec)])
    tsrv = tserve.SlotServer(tserved, tcfg, slots=2, cache_len=16, segment=2,
                             temperature=TEMP, seed=3, device="cpu")
    tout = tsrv.run([tserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
                     for i, (p, n, a) in enumerate(spec)])
    assert tout["outputs"] == jout["outputs"]


def test_eos_retires_mid_stream(slice_):
    _, tcfg, _, _, tserved, _ = slice_
    prompt = _prompts(5, (8,), tcfg.vocab_size)
    full = tserve.generate(tserved, tcfg, prompt[None], 8, 16,
                           adapters=[1], device="cpu")[0, -8:].tolist()
    eos = full[3]
    srv = tserve.SlotServer(tserved, tcfg, slots=2, cache_len=16, segment=3,
                            eos_id=eos, device="cpu")
    got = srv.run([tserve.Request(rid=0, prompt=prompt, max_new=8,
                                  adapter=1)])["outputs"][0]
    assert got == full[:full.index(eos) + 1]


def test_adapter_store_tables_bit_identical(slice_):
    """From the same numpy factors, the port's wrap builds the JAX tables
    bit for bit, in the same leaf order and (nb, G, dim, r) layout, and
    ragged ranks zero-pad the same way."""
    jcfg, tcfg, params, served, _, factors = slice_
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    tstore = tadapters.AdapterStore(
        tparams, tadapters.serving_target_fn(tcfg), G, 3)
    for i, (basis, rt, scale) in enumerate(factors):
        tstore.put(i, rt, basis, scale=scale)
    twrapped = tstore.wrap(tparams)
    is_j = lambda x: isinstance(x, jlayers.MultiAdapterDelta)   # noqa: E731
    is_t = lambda x: isinstance(x, tlayers.MultiAdapterDelta)   # noqa: E731
    jl, _ = jax.tree_util.tree_flatten_with_path(served, is_leaf=is_j)
    tl, _ = tree.tree_flatten_with_path(twrapped, is_leaf=is_t)
    assert len(jl) == len(tl)
    n_wrapped = 0
    for (jp, jleaf), (tp, tleaf) in zip(jl, tl):
        assert "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                        for q in jp) == tree.path_str(tp)
        if is_j(jleaf):
            n_wrapped += 1
            for name in ("bases", "rts", "scales"):
                a, b = np.asarray(getattr(jleaf, name)), \
                    getattr(tleaf, name).numpy()
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert n_wrapped == _n_targets(tcfg)
    # ragged rank: rank-2 factors into the rank-3 store, zero tail
    small = tadapters.AdapterStore(tparams,
                                   tadapters.serving_target_fn(tcfg), 1, 2)
    basis2, rt2 = small.random_factors(np.random.default_rng(0))
    tstore.put(1, rt2, basis2)
    b1 = tree.tree_leaves(tstore.store.gather(np.array([1]))["basis"])[0]
    assert np.array_equal(b1[0, ..., :2], tree.tree_leaves(basis2)[0])
    assert np.all(b1[0, ..., 2:] == 0)


def test_from_client_state_matches_jax(slice_):
    """A population's sticky delta rows served directly: the port's
    from_client_state + wrap build the JAX tables bit for bit."""
    from repro.core.population import ClientStateStore as JStore
    from repro_torch.core.population import ClientStateStore as TStore
    jcfg, tcfg, params, _, _, factors = slice_
    basis, rt, _ = factors[0]
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    stores = []
    for store_cls, adapters, prm, cfg, tmap in (
            (JStore, jadapters, params, jcfg, jax.tree_util.tree_map),
            (TStore, tadapters, tparams, tcfg, tree.tree_map)):
        cstore = store_cls(4, {"delta": tmap(
            lambda x: np.zeros(x.shape, np.float32), rt)})
        cstore.scatter(np.array([2]), tmap(lambda x: np.asarray(x)[None], rt))
        store = adapters.AdapterStore.from_client_state(
            prm, adapters.serving_target_fn(cfg), cstore, basis, ids=[2],
            base_scale=0.95)
        assert store.n_adapters == 4
        stores.append(store.wrap(prm, ids=np.array([2])))
    is_j = lambda x: isinstance(x, jlayers.MultiAdapterDelta)   # noqa: E731
    is_t = lambda x: isinstance(x, tlayers.MultiAdapterDelta)   # noqa: E731
    jleaves = [x for x in jax.tree_util.tree_leaves(stores[0], is_leaf=is_j)
               if is_j(x)]
    tleaves = [x for x in tree.tree_leaves(stores[1], is_leaf=is_t)
               if is_t(x)]
    assert len(jleaves) == len(tleaves) == _n_targets(tcfg)
    for jl, tl in zip(jleaves, tleaves):
        for name in ("bases", "rts", "scales"):
            assert np.array_equal(np.asarray(getattr(jl, name)),
                                  getattr(tl, name).numpy()), name


def test_demo_wrap_feeds_the_kernel_path(slice_):
    """demo_wrap wraps the target projections (seven for the GLU MLP,
    six for the plain one) with fp32 tables on the weights' device, and a
    wrapped forward reads all of them."""
    _, tcfg, _, _, _, _ = slice_
    tparams = tmodel.init_params(tcfg, seed=0, device="cpu")
    wrapped = tadapters.demo_wrap(tparams, tcfg, 4, rank=2, seed=3)
    leaves = [x for x in tree.tree_leaves(
        wrapped, is_leaf=lambda x: isinstance(x, tlayers.MultiAdapterDelta))
        if isinstance(x, tlayers.MultiAdapterDelta)]
    assert len(leaves) == _n_targets(tcfg)
    for leaf in leaves:
        assert leaf.bases.dtype == torch.float32
        assert leaf.bases.shape[:2] == (tcfg.n_blocks(), 4)
        assert leaf.scales.shape == (tcfg.n_blocks(), 4)
    out = tserve.generate(wrapped, tcfg, _prompts(6, (4, 5), tcfg.vocab_size),
                          3, 8, adapters=[0, 1, 2, 3], device="cpu")
    assert out.shape == (4, 8)


def test_errors(slice_, tmp_path):
    """The serving path's refusals; and ``AdapterStore(directory=)``
    spilling every tenant but one (one-tenant shards, one resident):
    its tables equal the unspilled JAX store's, and JAX's store reads
    its spill files."""
    jcfg, tcfg, jparams, jserved, tserved, factors = slice_
    prompts = torch.from_numpy(_prompts(8, (2, 4), tcfg.vocab_size))
    with torch.inference_mode():
        state = tmodel.init_decode_state(tcfg, 2, 8, device="cpu")
        with pytest.raises(ValueError, match="outside an adapter_ids"):
            tmodel.prefill(tserved, tcfg, prompts, state)
        with pytest.raises(ValueError, match="one id per decode row"):
            with tlayers.adapter_ids(torch.zeros((3,), dtype=torch.int32)):
                tmodel.prefill(tserved, tcfg, prompts, state)
        stacked = tree.tree_leaves(
            tserved, is_leaf=lambda x: isinstance(x,
                                                  tlayers.MultiAdapterDelta))
        leaf = next(x for x in stacked
                    if isinstance(x, tlayers.MultiAdapterDelta))
        with pytest.raises(ValueError, match="stacked base"):
            tlayers.multi_adapter_apply(leaf, prompts.float(),
                                        torch.zeros(2, dtype=torch.int32))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    store = tadapters.AdapterStore(
        tparams, tadapters.serving_target_fn(tcfg), G, 3,
        directory=str(tmp_path), shard_size=1, max_resident_shards=1)
    for i, (basis, rt, scale) in enumerate(factors):
        store.put(i, rt, basis, scale=scale)
    assert store.store.spills == G - 1
    got = store.wrap(tparams)
    is_delta = lambda x: isinstance(x, tlayers.MultiAdapterDelta)  # noqa
    want = [x for x in jax.tree_util.tree_leaves(
        jserved, is_leaf=lambda x: isinstance(x, jlayers.MultiAdapterDelta))
        if isinstance(x, jlayers.MultiAdapterDelta)]
    mine = [x for x in tree.tree_leaves(got, is_leaf=is_delta)
            if is_delta(x)]
    assert len(mine) == len(want) > 0
    for t, j in zip(mine, want):
        for f in ("bases", "rts", "scales"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    store.store.flush()
    jstore = jadapters.AdapterStore(
        jparams, jadapters.serving_target_fn(jcfg), G, 3,
        directory=str(tmp_path), shard_size=1, max_resident_shards=1)
    jrows = jstore.store.gather(np.arange(G))
    trows = store.store.gather(np.arange(G))
    for a, b in zip(jax.tree_util.tree_leaves(jrows),
                    tree.tree_leaves(trows)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("bad", [-1, G])
def test_out_of_range_adapter_ids_refused(slice_, bad):
    """An id outside the served tables is refused where requests come in,
    on every device, rather than served another tenant's adapter."""
    _, tcfg, _, _, tserved, _ = slice_
    prompts = _prompts(9, (2, 4), tcfg.vocab_size)
    for fn in (tserve.generate, tserve.generate_scan):
        with pytest.raises(ValueError, match="outside the 3 adapters"):
            fn(tserved, tcfg, prompts, 2, 8, adapters=[0, bad], device="cpu")
    srv = tserve.SlotServer(tserved, tcfg, slots=2, cache_len=8,
                            device="cpu")
    with pytest.raises(ValueError, match="outside the 3 adapters"):
        srv.submit(tserve.Request(rid=0, prompt=prompts[0], max_new=2,
                                  adapter=bad))
    assert not srv.queue


def test_tensor_matmul_defers_to_adapter_leaf():
    leaf = tlayers.MultiAdapterDelta(
        w=torch.ones(4, 6), bases=torch.zeros(1, 4, 2),
        rts=torch.zeros(1, 2, 6), scales=torch.ones(1))
    x = torch.ones(2, 4)
    assert torch.Tensor.__matmul__(x, leaf) is NotImplemented
    with tlayers.adapter_ids(torch.zeros(2, dtype=torch.int32)):
        assert torch.equal(x @ leaf, x @ leaf.w)


_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.utils.prng", "repro_torch.core.fed",
             "repro_torch.checkpoint", "repro_torch.checkpoint.io",
             "repro_torch.core.population",
             "repro_torch.core.ajive", "repro_torch.core.state_sync",
             "repro_torch.core.aggregation", "repro_torch.optim.adamw",
             "repro_torch.kernels.galore_adamw",
             "repro_torch.kernels.batched_eigh", "repro_torch.data.pipeline",
             "repro_torch.models.rwkv", "repro_torch.kernels.rwkv6_scan",
             "repro_torch.configs.rwkv6_1_6b", "repro_torch.models.mamba",
             "repro_torch.configs.deepseek_v2_236b",
             "repro_torch.configs.jamba_1_5_large_398b"):
    assert name in names, name
for name, path in (("chip_smoke", "chip_smoke.py"),
                   ("quickstart_torch", "examples/quickstart_torch.py"),
                   ("population_cohorts_torch",
                    "examples/population_cohorts_torch.py"),
                   ("serve_batched_torch",
                    "examples/serve_batched_torch.py")):
    spec = importlib.util.spec_from_file_location(name, ROOT + "/" + path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(sys.modules), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src
    root = os.path.dirname(src)
    res = subprocess.run([sys.executable, "-c",
                          f"ROOT = {root!r}\n" + _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_refuse_cpu_unless_asked():
    """No card here: the default device is CUDA, so every entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    cfg = smoke_variant(get_config(ARCH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--smoke", "--batch", "1", "--prompt-len", "2",
                     "--new-tokens", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.generate({}, cfg, np.zeros((1, 2), np.int32), 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.SlotServer({}, cfg, slots=1, cache_len=4)


def test_cli_runs_on_cpu_when_asked(capsys):
    res = tserve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--new-tokens", "3",
                       "--adapters", "2", "--adapter-rank", "2",
                       "--mode", "continuous", "--requests", "3"])
    assert res["device"] == "cpu" and res["requests"] == 3
    assert len(res["sample_row"]) == 3
