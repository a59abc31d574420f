"""Port parity of Mamba (the selective SSM of Jamba's interleave) and of
jamba-1.5-large-398b's smoke variant (one Mamba layer with a dense GLU,
one attention layer with an MoE of 4 experts top-2, no positional
embedding), JAX package vs ``repro_torch`` on the CPU with the JAX params
carried across by ``params_from_jax`` and JAX's decode states by
``decode_state_from_jax``.

Tolerances, each over the output's scale:
- Δ's softplus (``torch.nn.functional.softplus``) against
  ``jax.nn.softplus`` on [-40, 40] and around torch's threshold of 20:
  2e-7 relative (measured 1.55e-7, 2 fp32 ulp, at 100 of 4,005 points;
  none past the threshold, where torch returns x and exp(-x) is below
  half an ulp of x);
- ``mamba_forward`` with no state, from a state, and with
  ``return_state``: the output and h 1e-5; the bf16 conv taps within one
  bf16 ulp of their scale (both packages round the same fp32 inputs);
- ``mamba_decode`` chained over 6 tokens after a 6-token prefill, each
  package from its own state: every output 1e-4, the final h 1e-5;
- the smoke model: ``forward`` logits and MoE aux 1e-5, ``loss_fn`` and
  every gradient 1e-5 of its leaf's scale, ``prefill`` 1e-5,
  ``decode_step`` 1e-4 from JAX's state with scalar and per-slot ``t``;
  greedy ``generate`` / ``generate_scan`` tokens and ``SlotServer``
  outputs with adapters from JAX's ``AdapterStore`` identical.
The fp32 ``exp`` of the two packages (XLA's and torch's) can round one
ulp apart; no reading here comes near its bound from it.

About 24 s alone and serially (``PYTHONPATH=src JAX_PLATFORMS=cpu python
-m pytest -q -p no:xdist tests/test_torch_mamba.py``, 8 cores). Readings:
the layer 1.5e-7 forward (2.5e-7 from a state with ``return_state``),
1.8e-7 chained decode; the smoke model at most 1.1e-6 forward and
prefill, 1.9e-6 the worst gradient.
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
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as tmodel
from repro_torch.models.convert import decode_state_from_jax, params_from_jax
from repro_torch.utils import tree
from test_torch_families import _one_torch_thread, _rel, _t  # noqa: F401

ARCH = "jamba-1.5-large-398b"
FWD_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-5, 1e-4
B, L = 2, 12
D_MODEL = 32
DIMS = dict(d_model=D_MODEL, expand=2, d_state=16, d_conv=4)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


_j_forward = jax.jit(jmamba.mamba_forward,
                     static_argnames=("return_state", *DIMS))
_j_decode = jax.jit(jmamba.mamba_decode, static_argnames=tuple(DIMS))


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [19.99, 20.0, 20.01, 88.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    past = x > 20
    assert np.array_equal(got[past], want[past])


@pytest.fixture(scope="module")
def layer():
    """One Mamba mixer's params in both packages, an input (B, L, D) and
    a nonzero state (bf16 taps, fp32 h)."""
    jp = jmamba.mamba_init(jax.random.PRNGKey(0), D_MODEL, expand=2,
                           d_state=16, d_conv=4)
    # nonzero conv bias and dt bias, so both paths read them
    jp = dict(jp, conv_b=jnp.linspace(-0.1, 0.1, jp["conv_b"].shape[0]),
              dt_bias=jnp.linspace(-1.0, 1.0, jp["dt_bias"].shape[0]))
    tp = params_from_jax(_np_tree(jp), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, D_MODEL)).astype(np.float32)
    d_inner = 2 * D_MODEL
    st = jmamba.MambaState(
        conv=jnp.asarray(rng.standard_normal((B, 3, d_inner)),
                         jnp.bfloat16),
        h=jnp.asarray(0.3 * rng.standard_normal((B, d_inner, 16)),
                      jnp.float32))
    return jp, tp, x, st


def _state(jstate):
    return tmamba.MambaState(*(_t(a) for a in _np_tree(jstate)))


@pytest.mark.parametrize("case", ["fresh", "from_state", "return_state",
                                  "from_state_return_state"])
def test_mamba_forward_matches_jax(layer, case):
    jp, tp, x, jst = layer
    start = jst if "from_state" in case else None
    ret = case.endswith("return_state")
    jout = _j_forward(jp, jnp.asarray(x), start, return_state=ret, **DIMS)
    tstate = _state(jst) if start is not None else None
    with torch.inference_mode():
        tout = tmamba.mamba_forward(tp, torch.from_numpy(x), tstate,
                                    return_state=ret, **DIMS)
    if not ret:
        assert _rel(tout, jout) <= FWD_TOL
        return
    (tout, tst), (jout, jst2) = tout, jout
    assert _rel(tout, jout) <= FWD_TOL
    if tstate is not None:
        assert tst is tstate                  # written in place
    assert tst.conv.dtype == torch.bfloat16 and tst.h.dtype == torch.float32
    assert _rel(tst.h, jst2.h) <= FWD_TOL
    conv = np.asarray(jst2.conv.astype(jnp.float32))
    gap = np.max(np.abs(tst.conv.float().numpy() - conv))
    assert gap <= _bf16_ulp(np.max(np.abs(conv)))


def test_mamba_decode_chained_matches_jax(layer):
    """A 6-token prefill with ``return_state``, then ``mamba_decode`` over
    the other 6 tokens, each package from its own state."""
    jp, tp, x, _ = layer
    _, jst = _j_forward(jp, jnp.asarray(x[:, :6]), None, return_state=True,
                        **DIMS)
    with torch.inference_mode():
        _, tst = tmamba.mamba_forward(tp, torch.from_numpy(x[:, :6]),
                                      return_state=True, **DIMS)
        for i in range(6, L):
            jout, jst = _j_decode(jp, jnp.asarray(x[:, i:i + 1]), jst,
                                  **DIMS)
            tout, tst2 = tmamba.mamba_decode(
                tp, torch.from_numpy(x[:, i:i + 1]), tst, **DIMS)
            assert tst2 is tst
            assert tuple(tout.shape) == (B, 1, D_MODEL)
            assert _rel(tout, jout) <= DECODE_TOL
    assert _rel(tst.h, jst.h) <= FWD_TOL


# --------------------------------------------------- the smoke variant ----

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.layer_kinds() == [("mamba", "mlp"), ("attn", "moe")]
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
    (a Mamba state and a KV cache) with ``t`` scalar or per slot."""
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
    names = [type(s).__name__ for s in tstate.layers]
    assert names == [type(s).__name__ for s in jstate.layers] == \
        ["MambaState", "KVCache"]
    for got, want in zip(tstate.layers, jstate.layers):
        for g, w in zip(got, want):
            assert str(g.dtype).endswith(np.asarray(w).dtype.name)
    assert _rel(tstate.layers[0].h[0], jstate.layers[0].h[0]) <= FWD_TOL
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
    assert _rel(tstate.layers[0].h, jstate2.layers[0].h) <= FWD_TOL


@pytest.fixture(scope="module")
def served(model):
    """Three adapters (rank 3) on the serving target set (Mamba's in_proj
    and out_proj, attention's wq wk wv wo, the GLU's three; experts and
    routers frozen) in both packages."""
    jcfg, _, jparams, _, _, _ = model
    store = jadapters.AdapterStore(jparams, jadapters.serving_target_fn(jcfg),
                                   3, 3)
    rng = np.random.default_rng(4)
    for i in range(3):
        basis, rt = store.random_factors(rng, rt_scale=0.05)
        store.put(i, rt, basis, scale=1.0 - 0.01 * i)
    jserved = store.wrap(jparams)
    tserved = params_from_jax(_np_tree(jserved), "cpu")
    wrapped = sorted(
        f"{j}/{mod}/{k}" for j, blk in enumerate(tserved["blocks"])
        for mod, leaves in blk.items() if isinstance(leaves, dict)
        for k, v in leaves.items()
        if type(v).__name__ == "MultiAdapterDelta")
    assert wrapped == ["0/mamba/in_proj", "0/mamba/out_proj",
                       "0/mlp/w_down", "0/mlp/w_gate", "0/mlp/w_up",
                       "1/attn/wk", "1/attn/wo", "1/attn/wq", "1/attn/wv"]
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
    adapters through retire and admit (each admission inserts a Mamba
    state and a KV cache row): the port's outputs are JAX's."""
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
