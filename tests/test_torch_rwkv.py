"""Port parity for RWKV6 serving: rwkv6-1.6b (smoke variant, fp32, 2
layers, d 128, 2 heads of 64, d_ff 512) with heterogeneous adapters on its
eight target projections, JAX package vs ``repro_torch`` on the CPU.

The same numpy inputs, made from a seed, go through both packages:
- the WKV recurrence: the port's ``rwkv6_scan_ref`` (what ``ops.rwkv6_scan``
  runs on the CPU) against JAX's Pallas ``ops.rwkv6_scan`` in interpret
  mode (L a multiple of ``chunk``, as it asserts) and ``ref.rwkv6_scan_ref``
  (any L). fp32 y and the fp32 final state agree to 1e-5 of their scale —
  both sum D fp32 products per element, in different orders; bf16 y to
  one bf16 ulp of the output scale, since the fp32 sum is rounded once
  and a last-place difference can cross a rounding boundary;
- ``time_mix_forward`` / ``channel_mix_forward`` with ``return_state``
  (outputs and the returned state to 1e-5);
- prefill logits to 1e-5 and decode logits to 1e-4 (as for qwen); greedy
  tokens of ``generate``/``generate_scan`` and ``SlotServer`` outputs
  identical; ``AdapterStore`` tables bit for bit.
"""
import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import adapters as jadapters
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as scan_kernel
from repro_torch.launch import adapters as tadapters
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree

ARCH = "rwkv6-1.6b"
G = 3
SCAN_TOL = 1e-5          # fp32 y and s_final, relative to their scale
FWD_TOL = 1e-5           # time-mix / channel-mix outputs and states
PREFILL_TOL, DECODE_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _scan_inputs(seed, b, l, h, d, with_s0):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, l, h, d)) - 2.0))
         ).astype(np.float32)                                 # decay in (0,1)
    u = 0.3 * rng.standard_normal((h, d)).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((b, h, d, d)).astype(np.float32)
          if with_s0 else None)
    return r, k, v, w, u, s0


def _to_t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _to_j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _check_scan(got, want, dtype):
    (yt, st), (yj, sj) = got, want
    yj, sj = _np(yj), _np(sj)
    y_scale = np.max(np.abs(yj))
    y_err = np.max(np.abs(yt.float().numpy() - yj))
    y_tol = SCAN_TOL * y_scale if dtype == "float32" else _bf16_ulp(y_scale)
    assert y_err <= y_tol, (y_err, y_tol)
    s_err = np.max(np.abs(st.numpy() - sj))
    assert s_err <= SCAN_TOL * np.max(np.abs(sj)), s_err
    assert st.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_scan_matches_jax_pallas_and_ref(dtype, with_s0):
    """L a multiple of chunk: the port's plain version (through
    ``ops.rwkv6_scan`` on CPU tensors) against the Pallas kernel in
    interpret mode and against the JAX reference scan."""
    r, k, v, w, u, s0 = _scan_inputs(0, 2, 16, 2, 64, with_s0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tops.rwkv6_scan(_to_t(r, tdt), _to_t(k, tdt), _to_t(v, tdt),
                          _to_t(w), _to_t(u), _to_t(s0), chunk=8)
    assert got[0].dtype == tdt and got[0].shape == (2, 16, 2, 64)
    jargs = (_to_j(r, jdt), _to_j(k, jdt), _to_j(v, jdt), _to_j(w),
             _to_j(u), _to_j(s0))
    _check_scan(got, jops.rwkv6_scan(*jargs, chunk=8), dtype)
    _check_scan(got, jref.rwkv6_scan_ref(*jargs), dtype)


@pytest.mark.parametrize("l", [0, 1, 13])
def test_scan_any_length_matches_jax_ref(l):
    """Decode (L = 1), a ragged prompt and an empty one: the Pallas
    kernel asserts L % chunk == 0, so the JAX reference scan is the
    oracle."""
    r, k, v, w, u, s0 = _scan_inputs(1, 3, l, 2, 64, True)
    got = tref.rwkv6_scan_ref(*(_to_t(x) for x in (r, k, v, w, u, s0)))
    assert got[0].shape == (3, l, 2, 64)
    if l == 0:
        assert torch.equal(got[1], torch.from_numpy(s0))
        return
    _check_scan(got, jref.rwkv6_scan_ref(*(_to_j(x) for x in
                                           (r, k, v, w, u, s0))), "float32")


def test_kernel_wrapper_refuses_cpu_and_wide_heads():
    """The CUDA wrapper launches or raises: CPU tensors, D > 64, mixed
    r/k/v dtypes and wrong shapes are refused before any build."""
    r, k, v, w, u, _ = (_to_t(x) for x in _scan_inputs(2, 1, 4, 2, 64,
                                                         False))
    with pytest.raises(ValueError, match="CUDA device"):
        scan_kernel(r, k, v, w, u)
    wide = torch.zeros(1, 4, 1, 80)
    with pytest.raises(ValueError, match="D <= 64"):
        scan_kernel(wide, wide, wide, wide, torch.zeros(1, 80))
    with pytest.raises(ValueError, match="u "):
        scan_kernel(r, k, v, w, torch.zeros(3, 64))
    assert scan_kernel.launches == 0


def test_model_scan_routes_through_ops(monkeypatch):
    """A prefill runs the recurrence once per layer through
    ``kernels.ops.rwkv6_scan`` (the kernel on the card, its plain version
    here) with the state's fp32 WKV as s0."""
    calls = []
    orig = tops.rwkv6_scan

    def spy(r, k, v, w, u, s0=None, **kw):
        calls.append((tuple(r.shape), s0.dtype))
        return orig(r, k, v, w, u, s0, **kw)

    monkeypatch.setattr(tops, "rwkv6_scan", spy)
    cfg = smoke_variant(get_config(ARCH))
    p = tmodel.init_params(cfg, seed=0, device="cpu")
    st = tmodel.init_decode_state(cfg, 2, 0, device="cpu")
    with torch.inference_mode():
        tmodel.prefill(p, cfg, torch.zeros((2, 5), dtype=torch.int32), st)
    assert calls == [((2, 5, 2, 64), torch.float32)] * cfg.n_layers


# ------------------------------------------------------------ layers ----

def _layer_setup(seed=3):
    jcfg = jsmoke(jget_config(ARCH))
    d, dff = jcfg.d_model, jcfg.d_ff
    h = jrwkv.rwkv_heads(d)
    kt, kc = jax.random.split(jax.random.PRNGKey(seed))
    tp = jrwkv.time_mix_init(kt, d)
    cp = jrwkv.channel_mix_init(kc, d, dff)
    rng = np.random.default_rng(seed)
    # exercise the bonus and a spread of decays (the init has u = 0)
    tp["bonus_u"] = jnp.asarray(0.5 * rng.standard_normal((h, 64)),
                                jnp.float32)
    tp["decay_base"] = jnp.asarray(rng.uniform(-4, 1, d), jnp.float32)
    tp["mu"] = jnp.asarray(rng.uniform(0, 1, (5, d)), jnp.float32)
    cp["mu"] = jnp.asarray(rng.uniform(0, 1, (2, d)), jnp.float32)
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    state = jrwkv.RwkvState(
        shift_t=jnp.asarray(rng.standard_normal((2, d)), jnp.float32),
        shift_c=jnp.asarray(rng.standard_normal((2, d)), jnp.float32),
        wkv=jnp.asarray(0.3 * rng.standard_normal((2, h, 64, 64)),
                        jnp.float32))
    return jcfg, tp, cp, x, state


def _t_state(state):
    return trwkv.RwkvState(*(torch.from_numpy(np.array(s)) for s in state))


def _close(a, b, tol):
    b = np.asarray(b)
    return np.max(np.abs(np.asarray(a) - b)) <= tol * max(np.max(np.abs(b)),
                                                          1.0)


def test_time_mix_forward_matches_jax():
    jcfg, tp, _, x, state = _layer_setup()
    jout, jst = jrwkv.time_mix_forward(tp, jnp.asarray(x), state,
                                       jcfg.d_model, return_state=True)
    tp_t = params_from_jax(jax.tree_util.tree_map(np.asarray, tp), "cpu")
    tst = _t_state(state)
    wkv_buf = tst.wkv
    with torch.inference_mode():
        tout, tst2 = trwkv.time_mix_forward(tp_t, torch.from_numpy(x), tst,
                                            jcfg.d_model, return_state=True)
        plain = trwkv.time_mix_forward(tp_t, torch.from_numpy(x),
                                       _t_state(state), jcfg.d_model)
    assert tst2 is tst and tst2.wkv is wkv_buf          # written in place
    assert _close(tout.numpy(), jout, FWD_TOL)
    assert torch.equal(plain, tout)
    assert np.array_equal(tst.shift_t.numpy(), np.asarray(jst.shift_t))
    assert np.array_equal(tst.shift_c.numpy(), np.asarray(state.shift_c))
    assert _close(tst.wkv.numpy(), jst.wkv, FWD_TOL)


def test_channel_mix_forward_matches_jax():
    _, _, cp, x, state = _layer_setup(4)
    jout, jst = jrwkv.channel_mix_forward(cp, jnp.asarray(x), state,
                                          return_state=True)
    cp_t = params_from_jax(jax.tree_util.tree_map(np.asarray, cp), "cpu")
    tst = _t_state(state)
    with torch.inference_mode():
        tout, _ = trwkv.channel_mix_forward(cp_t, torch.from_numpy(x), tst,
                                            return_state=True)
    assert _close(tout.numpy(), jout, FWD_TOL)
    assert np.array_equal(tst.shift_c.numpy(), np.asarray(jst.shift_c))
    assert np.array_equal(tst.wkv.numpy(), np.asarray(state.wkv))


def test_state_writes_refuse_to_round():
    """A bf16 shift buffer under fp32 activations would round the state
    the JAX step keeps in fp32: the in-place write raises instead."""
    jcfg, tp, _, x, state = _layer_setup()
    tp_t = params_from_jax(jax.tree_util.tree_map(np.asarray, tp), "cpu")
    st = trwkv.rwkv_state_init(2, jcfg.d_model, dtype=torch.bfloat16)
    with torch.inference_mode(), pytest.raises(TypeError,
                                               match="activation dtype"):
        trwkv.time_mix_forward(tp_t, torch.from_numpy(x), st, jcfg.d_model,
                               return_state=True)


# ------------------------------------------------------------- model ----

@pytest.fixture(scope="module")
def slice_():
    """(jax cfg, torch cfg, jax base params, jax served, torch served,
    factors) for G random tenants."""
    jcfg = jsmoke(jget_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
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


def test_config_matches_jax():
    for j, t in ((jget_config(ARCH), get_config(ARCH)),
                 (jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH)))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.layer_kinds() == j.layer_kinds()
        assert t.block_period() == j.block_period() == 1
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab_size) == (24, 2048, 32, 7168, 65536)
    assert full.param_dtype == torch.bfloat16 and not full.tie_embeddings
    assert smoke_variant(full).param_dtype == torch.float32


def test_params_carry_the_rwkv_tree(slice_):
    """params_from_jax keeps every leaf's path, shape and dtype: fp32
    vectors, the 3-D ``maa_w2`` (no target) and eight adapter leaves per
    layer."""
    _, _, _, served, tserved, _ = slice_
    is_j = lambda x: isinstance(x, jlayers.MultiAdapterDelta)   # noqa: E731
    is_t = lambda x: isinstance(x, tlayers.MultiAdapterDelta)   # noqa: E731
    jl, _ = jax.tree_util.tree_flatten_with_path(served, is_leaf=is_j)
    tl, _ = tree.tree_flatten_with_path(tserved, is_leaf=is_t)
    assert len(jl) == len(tl)
    names = []
    for (jp, jleaf), (tp, tleaf) in zip(jl, tl):
        path = tree.path_str(tp)
        assert "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                        for q in jp) == path
        if is_j(jleaf):
            names.append(path)
            for f in ("w", "bases", "rts", "scales"):
                a, b = np.asarray(getattr(jleaf, f)), getattr(tleaf, f)
                assert tuple(b.shape) == a.shape and str(b.dtype).endswith(
                    a.dtype.name), f
            continue
        assert tuple(tleaf.shape) == jleaf.shape
        assert str(tleaf.dtype).endswith(np.asarray(jleaf).dtype.name), path
        assert np.array_equal(tleaf.numpy(), np.asarray(jleaf)), path
    assert sorted(n.split("/", 2)[2] for n in names) == sorted(
        ["cmix/wk", "cmix/wr", "cmix/wv", "tmix/wg", "tmix/wk", "tmix/wo",
         "tmix/wr", "tmix/wv"])


def test_prefill_and_decode_logits(slice_):
    jcfg, tcfg, _, served, tserved, _ = slice_
    prompts = _prompts(1, (G, 8), jcfg.vocab_size)
    ids = np.array([2, 0, 1], np.int32)
    jstate = jmodel.init_decode_state(jcfg, G, 16)
    with jlayers.adapter_ids(jnp.asarray(ids)):
        jl, jstate = jmodel.prefill(served, jcfg, jnp.asarray(prompts),
                                    jstate)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl2, jstate2 = jmodel.decode_step(served, jcfg, jtok, jstate)
    with torch.inference_mode():
        tstate = tmodel.init_decode_state(tcfg, G, 16, device="cpu")
        with tlayers.adapter_ids(torch.from_numpy(ids)):
            tl, tstate = tmodel.prefill(tserved, tcfg,
                                        torch.from_numpy(prompts), tstate)
            assert int(tstate.t) == 8 and tstate.t.ndim == 0
            prefill_wkv = tstate.layers[0].wkv.clone()
            tl2, tstate = tmodel.decode_step(
                tserved, tcfg, torch.from_numpy(np.asarray(jtok)), tstate)
    assert tl.dtype == torch.float32 and tl.shape == (G, jcfg.vocab_size)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= PREFILL_TOL
    assert np.max(np.abs(tl2.numpy() - np.asarray(jl2))) <= DECODE_TOL
    assert _close(prefill_wkv.numpy(), jstate.layers[0].wkv, 1e-5)
    for name in ("shift_t", "shift_c", "wkv"):
        a = getattr(tstate.layers[0], name)
        b = np.asarray(getattr(jstate2.layers[0], name))
        assert str(a.dtype).endswith(b.dtype.name), name   # fp32, as JAX's
        assert _close(a.numpy(), b, 1e-4), name


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


def test_slot_server_matches_jax(slice_):
    """Oversubscribed requests with mixed prompt lengths, budgets and
    adapters through retire+admit: the port's per-request outputs equal
    the JAX SlotServer's (whose carry it casts to the step's fp32
    shifts)."""
    jcfg, tcfg, _, served, tserved, _ = slice_
    rng = np.random.default_rng(4)
    spec = [(rng.integers(0, jcfg.vocab_size, 8 if i % 2 else 5),
             5 if i % 3 else 3, i % G) for i in range(5)]
    jsrv = jserve.SlotServer(served, jcfg, slots=2, cache_len=16, segment=2)
    jout = jsrv.run([jserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
                     for i, (p, n, a) in enumerate(spec)])
    tsrv = tserve.SlotServer(tserved, tcfg, slots=2, cache_len=16, segment=2,
                             device="cpu")
    for leaf, jleaf in zip(tsrv.state.layers[0], jsrv.state.layers[0]):
        assert str(leaf.dtype).endswith(np.asarray(jleaf).dtype.name)
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


def test_adapter_store_tables_bit_identical(slice_):
    """From the same numpy factors, the port's wrap builds the JAX tables
    for the eight RWKV targets bit for bit, in the same leaf order."""
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
    jleaves = [x for x in jax.tree_util.tree_leaves(served, is_leaf=is_j)
               if is_j(x)]
    tleaves = [x for x in tree.tree_leaves(twrapped, is_leaf=is_t)
               if is_t(x)]
    assert len(jleaves) == len(tleaves) == 8
    for jl, tl in zip(jleaves, tleaves):
        for name in ("bases", "rts", "scales"):
            a, b = np.asarray(getattr(jl, name)), getattr(tl, name).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_demo_wrap_feeds_the_kernel_path(monkeypatch):
    """demo_wrap wraps the eight targets with (nb, G, dim, r) fp32 tables,
    and a wrapped generate reads all of them."""
    tcfg = smoke_variant(get_config(ARCH))
    tparams = tmodel.init_params(tcfg, seed=0, device="cpu")
    wrapped = tadapters.demo_wrap(tparams, tcfg, 4, rank=2, seed=3)
    leaves = [x for x in tree.tree_leaves(
        wrapped, is_leaf=lambda x: isinstance(x, tlayers.MultiAdapterDelta))
        if isinstance(x, tlayers.MultiAdapterDelta)]
    assert len(leaves) == 8
    for leaf in leaves:
        assert leaf.bases.dtype == torch.float32
        assert leaf.bases.shape[:2] == (tcfg.n_blocks(), 4)
    seen = []
    orig = tops.lowrank_linear_batched

    def spy(x, w, *a, **kw):
        seen.append(tuple(w.shape))
        return orig(x, w, *a, **kw)

    monkeypatch.setattr(tops, "lowrank_linear_batched", spy)
    out = tserve.generate(wrapped, tcfg, _prompts(6, (4, 5), tcfg.vocab_size),
                          3, 8, adapters=[0, 1, 2, 3], device="cpu")
    assert out.shape == (4, 8)
    d, f = tcfg.d_model, tcfg.d_ff
    per_forward = sorted([(d, d)] * 6 + [(d, f), (f, d)]) * tcfg.n_layers
    assert sorted(seen) == sorted(per_forward * 3)    # prefill + 2 decodes


def test_training_is_a_later_slice(slice_):
    """Training was the slice after serving; it is ported now: the
    training ``forward`` and ``loss_fn`` run on the smoke model from JAX's
    params and give JAX's logits and loss (their gradients are
    ``test_torch_rwkv_train.py``'s)."""
    jcfg, tcfg, params, _, _, _ = slice_
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              "cpu")
    tokens = _prompts(8, (2, 9), jcfg.vocab_size)
    labels = _prompts(9, (2, 9), jcfg.vocab_size)
    labels[:, :3] = -1
    jlogits, _ = jmodel.forward(params, jcfg, jnp.asarray(tokens))
    jloss = jmodel.loss_fn(params, jcfg, {"tokens": jnp.asarray(tokens),
                                          "labels": jnp.asarray(labels)})
    with torch.no_grad():
        logits, aux = tmodel.forward(tparams, tcfg, torch.from_numpy(tokens))
        loss = tmodel.loss_fn(tparams, tcfg,
                              {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)})
    assert logits.shape == (2, 9, tcfg.vocab_size) and float(aux) == 0.0
    assert _close(logits.numpy(), jlogits, PREFILL_TOL)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_cli_serves_rwkv_on_cpu_when_asked():
    for mode in ("scan", "continuous"):
        res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "5",
                           "--new-tokens", "3", "--adapters", "2",
                           "--adapter-rank", "2", "--mode", mode,
                           "--requests", "3"])
        assert res["arch"] == "rwkv6-1.6b-smoke" and res["device"] == "cpu"
        assert len(res["sample_row"]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--arch", ARCH, "--smoke", "--batch", "1",
                         "--prompt-len", "2", "--new-tokens", "1"])


@pytest.mark.parametrize("d", [64, 40])
def test_scan_ref_keeps_the_kernels_arithmetic_order(d):
    """The plain version computes, bit for bit, the order the CUDA kernel
    is written in (csrc/rwkv6_scan.cu): kv = k_i v_j, p_i = r_i (S_ij +
    u_i kv), S_ij <- w_i S_ij + kv, every operation rounded to fp32 on
    its own, and y_j the pairwise tree of adjacent pairs over the
    products zero-padded to 64. Spelled out here in numpy float32."""
    r, k, v, w, u, s0 = _scan_inputs(4, 2, 5, 2, d, True)
    f = np.float32
    s = s0.copy()
    y = np.zeros_like(r)
    for t in range(r.shape[1]):
        kv = (k[:, t, :, :, None] * v[:, t, :, None, :]).astype(f)
        p = np.zeros(s.shape[:2] + (64, d), f)
        p[:, :, :d] = r[:, t, :, :, None] * (s + u[None, :, :, None] * kv)
        while p.shape[2] > 1:
            p = p[:, :, 0::2] + p[:, :, 1::2]
        y[:, t] = p[:, :, 0]
        s = w[:, t, :, :, None] * s + kv
    got_y, got_s = tref.rwkv6_scan_ref(*(_to_t(x) for x in
                                         (r, k, v, w, u, s0)))
    assert np.array_equal(got_y.numpy(), y)
    assert np.array_equal(got_s.numpy(), s)


# ------------------------------------------- the kernel's plan, on CPU ----

_scan_mod = importlib.import_module("repro_torch.kernels.rwkv6_scan")
# (b, l, h, sms): one 128-token prompt (4 rows a lane), 8 prompts and 8
# decode rows on a card too small for one wave of them (16 rows a lane;
# decode reduces one step at a time), an empty sequence.
_PLAN_CASES = [(1, 128, 2, 132), (8, 128, 2, 2), (8, 1, 2, 2), (2, 0, 2, 132)]


def test_plan_of_the_serving_shapes():
    """rwkv6-1.6b's calls on an H100 (132 SMs): an admission prefill keeps
    4 rows a lane over 128 blocks; generate's 8 prompts and decode take 16
    rows a lane (one wave), decode one step at a time; a longer sequence
    than ``chunk`` gets the second slot."""
    p = _scan_mod.plan(1, 128, 32, 64, 128, 132)
    assert (p.rows, p.lanes, p.group, p.cols, p.blocks, p.threads,
            p.staged, p.slots) == (4, 16, 8, 16, 128, 256, 128, 1)
    assert _scan_mod.plan(1, 100, 32, 64, 128, 132).staged == 100
    p = _scan_mod.plan(8, 128, 32, 64, 128, 132)
    assert (p.rows, p.lanes, p.group, p.blocks) == (16, 4, 8, 256)
    p = _scan_mod.plan(8, 1, 32, 64, 128, 132)
    assert (p.rows, p.group, p.blocks, p.staged, p.slots) == (16, 1, 256, 1,
                                                             1)
    p = _scan_mod.plan(2, 129, 32, 64, 64, 132)
    assert (p.staged, p.slots) == (64, 2)


@pytest.mark.parametrize("case", _PLAN_CASES)
@pytest.mark.parametrize("d", [1, 17, 33, 40, 64])
def test_plan_covers_every_row_of_every_column_once(d, case):
    """``plan`` is pure, its blocks are whole warps of at most 256 threads,
    and the threads (decoded as the kernel decodes them, ``owner``) hold
    every row i < D of every column j < D of every (b, h) exactly once."""
    b, l, h, sms = case
    p = _scan_mod.plan(b, l, h, d, 128, sms)
    assert p == _scan_mod.plan.__wrapped__(b, l, h, d, 128, sms)
    assert p.rows * p.lanes == 64 and p.threads == p.cols * p.lanes
    assert p.threads % 32 == 0 and p.threads <= 256
    assert p.blocks == b * h * p.col_blocks and p.cols * p.col_blocks >= d
    held = np.zeros((b * h, d, d), np.int64)          # (b h, row, column)
    for blk in range(p.blocks):
        for thread in range(p.threads):
            bh, j, r0 = _scan_mod.owner(p, blk, thread)
            if j < d:
                held[bh, r0:min(r0 + p.rows, d), j] += 1
    assert (held == 1).all()


def _emulate_tree(p, x):
    """y over the steps of x (D, G, N) fp32 in the kernel's order for plan
    ``p``: each lane sums its rows (zero-padded to 64) as adjacent
    pairs, then the reduce-scatter of ``csrc/rwkv6_scan.cu`` (keep half,
    add the half lane q ^ 2^l sends back; then the butterfly across the
    lanes left). Returns {step: (lane, value)} of the lanes that store."""
    d, g = x.shape[0], p.group
    pad = torch.zeros((64,) + x.shape[1:], dtype=torch.float32)
    pad[:d] = x
    part = []
    for q in range(p.lanes):
        rows = list(pad[q * p.rows:(q + 1) * p.rows])
        while len(rows) > 1:
            rows = [rows[a] + rows[a + 1] for a in range(0, len(rows), 2)]
        part.append(list(rows[0]))                     # g values of (N,)
    sigma = [0] * p.lanes
    lev = min(p.lanes, g).bit_length() - 1
    for lv in range(lev):
        half = (g >> lv) // 2
        new = []
        for q in range(p.lanes):
            lo = half if (q >> lv) & 1 else 0        # the half lane q keeps
            mine, sent = part[q], part[q ^ (1 << lv)]
            new.append([mine[lo + i] + sent[lo + i] for i in range(half)])
            sigma[q] += lo
        part = new
    off = g
    while off < p.lanes:
        part = [[part[q][0] + part[q ^ off][0]] for q in range(p.lanes)]
        off *= 2
    stored = {}
    for q in range(min(p.lanes, g)):
        for i, val in enumerate(part[q]):
            assert sigma[q] + i not in stored
            stored[sigma[q] + i] = (q, val)
    return stored


@pytest.mark.parametrize("case", _PLAN_CASES[:3])
@pytest.mark.parametrize("d", [1, 17, 33, 40, 64])
def test_planned_reduction_order_is_the_pairwise_sum(d, case):
    """The kernel's sum over rows, emulated in torch fp32 for the plan —
    in-lane adjacent pairs, then xor-shuffle levels — is bitwise the plain
    version's ``_pairwise_sum``, and each of a group's steps is stored by
    exactly one lane. Inputs span eight decades, so any other order
    rounds differently."""
    b, l, h, sms = case
    p = _scan_mod.plan(b, l, h, d, 128, sms)
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((d, p.group, 64))
         * 10.0 ** rng.uniform(-4, 4, (d, p.group, 64))).astype(np.float32)
    want = tref._pairwise_sum(torch.from_numpy(x).reshape(d, -1))
    want = want.reshape(p.group, 64)
    stored = _emulate_tree(p, torch.from_numpy(x))
    assert sorted(stored) == list(range(p.group))
    for step, (_, val) in stored.items():
        assert torch.equal(val.view(torch.int32), want[step].view(torch.int32))


@pytest.mark.parametrize("sizes", [(2, 4), (2, 2), (4, 4), (4, 2)],
                         ids=["bf16-fp32w", "bf16-bf16w", "fp32-fp32w",
                              "fp32-bf16w"])
@pytest.mark.parametrize("shape", [(1, 128), (1, 300), (2, 300), (8, 300),
                                   (8, 129), (8, 1)])
def test_plan_stages_within_shared_memory(shape, sizes):
    """With ``chunk`` 128, every r/k/v and w type takes any L: two slots
    are cut to whole groups that fit in an sm_90 block's shared memory
    (fp32 operands), and bf16 r/k/v keep the full chunk. ``smem`` is what
    the launcher asks for: the slots of r, k, v, w in their own types and
    the fp32 S tile."""
    (b, l), (rkv, w) = shape, sizes
    p = _scan_mod.plan(b, l, 32, 64, 128, 132, rkv, w)
    step = 64 * (3 * rkv + w)
    assert p.smem == p.slots * p.staged * step + 64 * (p.cols + 1) * 4
    assert p.smem <= _scan_mod.SMEM_OPTIN
    assert p.slots == (2 if l > p.staged else 1)
    assert 1 <= p.staged <= min(128, l)
    if rkv == 2 or l <= 128:
        assert p.staged == min(128, l)
    else:
        assert p.staged % 8 == 0 and p.staged >= 96
