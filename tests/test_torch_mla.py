"""Port parity of MLA (DeepSeek-V2's multi-head latent attention) and of
deepseek-v2-236b's smoke variant (2 layers of MLA + MoE, 4 experts top-2
plus a shared expert), JAX package vs ``repro_torch`` on the CPU with the
JAX params carried across by ``params_from_jax`` and JAX's decode states
by ``decode_state_from_jax``.

Tolerances, each over the output's scale:
- ``mla_forward``, direct and blockwise (``attn_chunk`` 4 on 12 tokens,
  with and without a window): the output, c_kv and k_pe 1e-5;
- ``mla_cache_write``: bit for bit, with a scalar or per-row ``t``, and
  a write longer than the ring on both branches, under a dispatch guard
  that fails a scatter with a repeated index (ROADMAP Queue 3 p);
- ``mla_decode`` from JAX's bf16 cache, scalar and per-slot ``t``: the
  output 1e-4 and the written cache bit for bit;
- the smoke model: ``forward`` logits and MoE aux 1e-5, ``loss_fn`` and
  every gradient 1e-5 of its leaf's scale, ``prefill`` 1e-5,
  ``decode_step`` 1e-4 from JAX's state with scalar and per-slot ``t``;
  greedy ``generate`` / ``generate_scan`` tokens and ``SlotServer``
  outputs with adapters from JAX's ``AdapterStore`` identical.

About 31 s alone and serially (``PYTHONPATH=src JAX_PLATFORMS=cpu python
-m pytest -q -p no:xdist tests/test_torch_mla.py``; 54 s together with
``test_torch_mamba.py``, 8 cores). Readings: the layer 1.2e-7 forward,
2.0e-7 decode; the smoke model 1.1e-6 forward and prefill, 1.9e-6 the
worst gradient.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.launch import adapters as jadapters
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from repro_torch.utils import tree
from test_torch_families import _one_torch_thread, _rel, _t  # noqa: F401
from test_torch_serve import _NoRepeatedScatter

ARCH = "deepseek-v2-236b"
FWD_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-5, 1e-4
B, L = 2, 12
DIMS = dict(n_heads=4, qk_nope=16, qk_rope=8, kv_lora=16, v_dim=16)
D_MODEL, Q_LORA = 64, 32


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# The JAX side runs jitted: op by op it takes most of the file's time.
_j_forward = jax.jit(jattn.mla_forward,
                     static_argnames=("window", "attn_chunk", *DIMS))
_j_decode = jax.jit(jattn.mla_decode, static_argnames=tuple(DIMS))
_j_write = jax.jit(jattn.mla_cache_write)


@pytest.fixture(scope="module")
def layer():
    """One MLA mixer's params in both packages and an input (B, L, D)."""
    jp = jattn.mla_init(jax.random.PRNGKey(0), D_MODEL, DIMS["n_heads"],
                        q_lora=Q_LORA, kv_lora=DIMS["kv_lora"],
                        qk_nope=DIMS["qk_nope"], qk_rope=DIMS["qk_rope"],
                        v_dim=DIMS["v_dim"])
    tp = params_from_jax(_np_tree(jp), "cpu")
    x = np.random.default_rng(1).standard_normal(
        (B, L, D_MODEL)).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("chunk,window", [(0, 0), (4, 0), (4, 5)],
                         ids=["direct", "blockwise", "blockwise-window"])
def test_mla_forward_matches_jax(layer, chunk, window):
    jp, tp, x = layer
    pos = np.arange(L)
    jout, (jckv, jkpe) = _j_forward(
        jp, jnp.asarray(x), jnp.asarray(pos), window=window,
        attn_chunk=chunk, **DIMS)
    tout, (tckv, tkpe) = tattn.mla_forward(
        tp, torch.from_numpy(x), torch.from_numpy(pos), window=window,
        attn_chunk=chunk, **DIMS)
    for got, want in ((tout, jout), (tckv, jckv), (tkpe, jkpe)):
        assert _rel(got, want) <= FWD_TOL


def test_mla_blockwise_equals_direct_route(layer):
    """The blockwise route computes the direct route's function."""
    _, tp, x = layer
    pos = torch.arange(L)
    direct, _ = tattn.mla_forward(tp, torch.from_numpy(x), pos, **DIMS)
    blocks, _ = tattn.mla_forward(tp, torch.from_numpy(x), pos,
                                  attn_chunk=4, **DIMS)
    assert _rel(blocks, direct.numpy()) <= FWD_TOL


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("ln", [3, 40], ids=["short", "longer_than_ring"])
def test_mla_cache_write_matches_jax(per_row, ln):
    """The ring write leaves JAX's ckv, kpe and pos bit for bit, a write of
    more positions than the 16 slots included (its last 16 kept), with no
    repeated index in any scatter."""
    rng = np.random.default_rng(7 + per_row + ln)
    size, kvl, rope = 16, DIMS["kv_lora"], DIMS["qk_rope"]
    ckv = rng.standard_normal((B, ln, kvl)).astype(np.float32)
    kpe = rng.standard_normal((B, ln, rope)).astype(np.float32)
    t0 = np.array([2, 9], np.int32) if per_row else 5
    jc = jattn.mla_cache_init(B, size, kvl, rope, jnp.float32)
    if ln <= size:     # a write onto earlier contents
        jc = _j_write(jc, jnp.ones((B, 4, kvl)), jnp.ones((B, 4, rope)),
                      jnp.asarray(0))
    want = _j_write(jc, jnp.asarray(ckv), jnp.asarray(kpe), jnp.asarray(t0))
    got = tattn.MLACache(*(_t(x) for x in _np_tree(jc)))
    with torch.inference_mode(), _NoRepeatedScatter():
        out = tattn.mla_cache_write(got, torch.from_numpy(ckv),
                                    torch.from_numpy(kpe),
                                    torch.from_numpy(t0) if per_row else t0)
    assert out is got
    for name, g, w in zip(("ckv", "kpe", "pos"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_matches_jax(layer, per_slot):
    """One absorbed-form step from JAX's bf16 cache (filled by a prefill
    of L - 1 positions): the output within 1e-4, the cache written in
    place as JAX writes it."""
    jp, tp, x = layer
    _, (ckv, kpe) = _j_forward(jp, jnp.asarray(x[:, :-1]),
                               jnp.arange(L - 1), **DIMS)
    jc = _j_write(
        jattn.mla_cache_init(B, L + 4, DIMS["kv_lora"], DIMS["qk_rope"]),
        ckv, kpe, jnp.asarray(0))
    t = np.array([L - 1, L - 3], np.int32) if per_slot else L - 1
    jout, jc2 = _j_decode(jp, jnp.asarray(x[:, -1:]), jc, jnp.asarray(t),
                          **DIMS)
    tc = tattn.MLACache(*(_t(a) for a in _np_tree(jc)))
    with torch.inference_mode():
        tout, tc2 = tattn.mla_decode(tp, torch.from_numpy(x[:, -1:]), tc,
                                     torch.from_numpy(np.asarray(t)), **DIMS)
    assert tc2 is tc
    assert _rel(tout, jout) <= DECODE_TOL
    for name, g, w in zip(("ckv", "kpe", "pos"), tc, jc2):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w.astype(jnp.float32))), name


# --------------------------------------------------- the smoke variant ----

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert {k for k in tcfg.layer_kinds()} == {("mla", "moe")}
    jparams = jax.jit(jmodel.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (B, L), dtype=np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, L), dtype=np.int32)
    labels[0, :3] = -1
    return jcfg, tcfg, jparams, tparams, tokens, labels


def test_forward_and_aux(model):
    jcfg, tcfg, jparams, tparams, tokens, _ = model
    jl, jaux = jax.jit(jmodel.forward, static_argnums=1)(
        jparams, jcfg, jnp.asarray(tokens))
    tl, taux = tmodel.forward(tparams, tcfg, torch.from_numpy(tokens))
    assert _rel(tl, jl) <= FWD_TOL
    assert float(jaux) > 0
    assert abs(float(taux) - float(jaux)) <= FWD_TOL * abs(float(jaux))


def test_loss_and_grad(model):
    jcfg, tcfg, jparams, tparams, tokens, labels = model
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, jbatch)))(jparams)
    leaves = [x.clone().requires_grad_(True)
              for x in tree.tree_leaves(tparams)]
    _, tdef = tree.tree_flatten(tparams)
    tloss = tmodel.loss_fn(tdef.unflatten(leaves), tcfg,
                           {k: _t(v) for k, v in jbatch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL * abs(float(jloss))
    jg = jax.tree_util.tree_leaves(jgrads)
    assert len(jg) == len(leaves)
    worst = max(_rel(x.grad, g) for x, g in zip(leaves, jg)
                if np.max(np.abs(np.asarray(g))) > 0)
    assert worst <= GRAD_TOL, worst


@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode(model, per_slot):
    """Prefill over L - 1 tokens, then one decode step from JAX's state
    with ``t`` scalar or per slot (row 1 a position behind)."""
    jcfg, tcfg, jparams, tparams, tokens, _ = model
    cache = L + 4
    jstate = jmodel.init_decode_state(jcfg, B, cache)
    jl, jstate = jax.jit(jmodel.prefill, static_argnums=1)(
        jparams, jcfg, jnp.asarray(tokens[:, :-1]), jstate)
    with torch.inference_mode():
        tstate = tmodel.init_decode_state(tcfg, B, cache, device="cpu")
        tl, tstate = tmodel.prefill(tparams, tcfg,
                                    torch.from_numpy(tokens[:, :-1]), tstate)
    assert int(tstate.t) == L - 1 == int(jstate.t)
    assert _rel(tl, jl) <= FWD_TOL
    for got, want in zip(tstate.layers, jstate.layers):
        assert type(got).__name__ == type(want).__name__ == "MLACache"
        assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    if per_slot:
        jstate = jstate._replace(t=jnp.array([L - 1, L - 2], jnp.int32))
    jd, jstate2 = jax.jit(jmodel.decode_step, static_argnums=1)(
        jparams, jcfg, jnp.asarray(tokens[:, -1]), jstate)
    tstate = decode_state_from_jax(_np_tree(jstate), "cpu")
    with torch.inference_mode():
        td, tstate = tmodel.decode_step(tparams, tcfg,
                                        torch.from_numpy(tokens[:, -1]),
                                        tstate)
    assert _rel(td, jd) <= DECODE_TOL
    assert tstate.t.ndim == (1 if per_slot else 0)
    assert np.array_equal(tstate.layers[0].pos.numpy(),
                          np.asarray(jstate2.layers[0].pos))


@pytest.fixture(scope="module")
def served(model):
    """Three adapters (rank 3) on the serving target set (q_a, q_b, kv_a
    and wo; kv_b, experts and routers frozen) in both packages."""
    jcfg, _, jparams, _, _, _ = model
    store = jadapters.AdapterStore(jparams, jadapters.serving_target_fn(jcfg),
                                   3, 3)
    rng = np.random.default_rng(4)
    for i in range(3):
        basis, rt = store.random_factors(rng, rt_scale=0.05)
        store.put(i, rt, basis, scale=1.0 - 0.01 * i)
    jserved = store.wrap(jparams)
    tserved = params_from_jax(_np_tree(jserved), "cpu")
    wrapped = sorted(k for k, v in tserved["blocks"][0]["attn"].items()
                     if type(v).__name__ == "MultiAdapterDelta")
    assert wrapped == ["kv_a", "q_a", "q_b", "wo"]
    return jserved, tserved


@pytest.mark.parametrize("scan", [False, True],
                         ids=["generate", "generate_scan"])
def test_greedy_tokens_match_jax(model, served, scan):
    jcfg, tcfg = model[:2]
    jserved, tserved = served
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab_size, (3, 8), dtype=np.int32)
    ids = np.array([2, 0, 1], np.int32)
    jgen = jserve.generate_scan if scan else jserve.generate
    tgen = tserve.generate_scan if scan else tserve.generate
    want = jgen(jserved, jcfg, jnp.asarray(prompts), 5, 16,
                adapters=jnp.asarray(ids))
    got = tgen(tserved, tcfg, prompts, 5, 16, adapters=ids, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_slot_server_matches_jax(model, served):
    """Oversubscribed requests with mixed prompt lengths, budgets and
    adapters through retire and admit: the port's outputs are JAX's."""
    jcfg, tcfg = model[:2]
    jserved, tserved = served
    rng = np.random.default_rng(6)
    spec = [(rng.integers(0, jcfg.vocab_size, 8 if i % 2 else 5),
             5 if i % 3 else 3, i % 3) for i in range(5)]
    jout = jserve.SlotServer(jserved, jcfg, slots=2, cache_len=16,
                             segment=2).run(
        [jserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
         for i, (p, n, a) in enumerate(spec)])
    tsrv = tserve.SlotServer(tserved, tcfg, slots=2, cache_len=16, segment=2,
                             device="cpu")
    tout = tsrv.run([tserve.Request(rid=i, prompt=p, max_new=n, adapter=a)
                     for i, (p, n, a) in enumerate(spec)])
    assert tout["outputs"] == jout["outputs"]
    assert tout["stats"]["admitted"] == 5 and not tsrv.active.any()
