"""Port parity: the runtime's other round forms and the step functions of
``launch/steps.py`` against JAX's (set-up and tolerances:
``torch_runtime_pair.py``).

- ``refresh_mode="svd"`` (``refresh_every`` 2): every client refreshes its
  basis from its own gradient, so 𝒜 contracts per-client lifts and 𝒮 runs
  over r×r transfer Grams. Stacked states 1.7e-4 (the RSVD bases, ROADMAP
  Queue 3 e), leaves 2.7e-5.
- deepseek-v2-236b's smoke model: MLA with ``attn_chunk`` set, so the
  round reads its targets through the transient lift in every round (the
  gate of ``make_fed_round_step``), as JAX's does; losses 9.5e-7, leaves
  1.5e-5, states 2.0e-5. With ``attn_chunk`` 0 the same round is
  lift-free.
- ``make_fed_local_step`` (two steps of every client), ``sync_client_
  states`` on random client stacks (each protocol, factored on a shared
  basis, dense, and over diverged bases), ``make_prefill_step`` /
  ``make_decode_step``.

ROADMAP Queue 3 ad records the readings. The file takes ≈ 45 s alone.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import galore as jgal
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as jmesh
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import galore as tgal
from repro_torch.fedsim import ShardedFederation
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import (decode_state_from_jax,
                                        opt_state_from_jax, params_from_jax)
from repro_torch.utils import tree

import torch_runtime_pair as rp

SVD = dict(refresh_mode="svd", refresh_every=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def svd_round():
    jf, tf, jcfg, _ = rp.pair(spec=SVD)
    return rp.run_round(jf, tf, rp.batches(jcfg.vocab_size, 0))


def test_svd_round_matches_jax(svd_round):
    rp.assert_matches(svd_round)


@pytest.fixture(scope="module")
def deepseek():
    jf, tf, jcfg, tcfg = rp.pair(rp.DEEPSEEK)
    recs = []
    for r in range(2):
        with rp.Calls() as calls:
            rec = rp.run_round(jf, tf, rp.batches(jcfg.vocab_size, r))
        recs.append((rec, calls.n))
    return tcfg, recs


@pytest.mark.parametrize("rnd", [0, 1])
def test_deepseek_round_matches_jax(deepseek, rnd):
    rp.assert_matches(deepseek[1][rnd][0])


def _reads(calls):
    return {k: calls.get(k, 0) for k in
            ("lift_client_trainable", "liftfree_value_and_grad",
             "lowrank_linear", "galore_precond_step")}


def test_deepseek_takes_the_transient_read(deepseek):
    """MLA with ``attn_chunk`` on: every local step lifts and runs the
    fused preconditioner, one launch a shape bucket; no lift-free read."""
    cfg, recs = deepseek
    assert cfg.mla and cfg.attn_chunk
    n_buckets = 5           # q_a, q_b, kv_a, kv_b and wo: five shapes
    for _, calls in recs:
        assert _reads(calls) == {
            "lift_client_trainable": rp.C * rp.T,
            "liftfree_value_and_grad": 0, "lowrank_linear": 0,
            "galore_precond_step": rp.C * rp.T * n_buckets}


def test_mla_without_attn_chunk_reads_lift_free():
    cfg = dataclasses.replace(smoke_variant(get_config(rp.DEEPSEEK)),
                              attn_chunk=0)
    fed = ShardedFederation(cfg, tsteps.TrainSpec(**rp.SPEC),
                            make_host_mesh(1, device="cpu"), rp.C)
    with rp.Calls() as calls:
        fed.run_round(rp.batches(cfg.vocab_size, 0))
    n = _reads(calls.n)
    assert n["liftfree_value_and_grad"] == rp.C * rp.T
    assert n["lift_client_trainable"] == n["galore_precond_step"] == 0
    assert n["lowrank_linear"] == rp.C * rp.T * 5 * cfg.n_layers


# ------------------------------------------------------- the step functions

def _jax_state(jcfg, spec):
    key = jax.random.PRNGKey(0)
    return jsteps.init_train_state(key, jcfg, jsteps.TrainSpec(**spec))


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def test_fed_local_step_matches_jax():
    jcfg = jsmoke(jget_config(rp.QWEN))
    tcfg = smoke_variant(get_config(rp.QWEN))
    tr, fr, st = _jax_state(jcfg, rp.SPEC)
    jtr = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (rp.C,) + x.shape), tr)
    jst = jgal.stack_opt_state(st, rp.C, copy=True)
    ttr = params_from_jax(_np(jtr), "cpu")
    tfr = params_from_jax(_np(fr), "cpu")
    tst = opt_state_from_jax(_np(jst), "cpu")
    jstep = jax.jit(jsteps.make_fed_local_step(
        jcfg, jsteps.TrainSpec(**rp.SPEC), rp.C))
    tstep = tsteps.make_fed_local_step(tcfg, tsteps.TrainSpec(**rp.SPEC),
                                       rp.C)
    b = rp.batches(jcfg.vocab_size, 3)
    for t in range(2):
        bt = {k: v[:, t] for k, v in b.items()}
        with jmesh(1):
            jtr, jst, jloss = jstep(jtr, fr, jst,
                                    {k: jnp.asarray(v) for k, v in bt.items()})
        ttr, tst, tloss = tstep(ttr, tfr, tst,
                                tree.tree_map(torch.as_tensor, bt))
        assert np.max(np.abs(tloss.numpy() - np.asarray(jloss))) \
            <= rp.LOSS_TOL
    for got, want in zip(tree.tree_leaves(ttr),
                         jax.tree_util.tree_leaves(jtr)):
        assert rp.rel(got.float().numpy(), want) <= rp.PARAM_TOL
    ja, js = rp.state(jst, jax.tree_util.tree_leaves)
    ta, ts = rp.state(tst, tree.tree_leaves)
    assert all(rp.rel(g, w) <= rp.STATE_TOL for g, w in zip(ta, ja))
    assert [int(np.unique(x)[0]) for x in ts] == \
        [int(np.unique(x)[0]) for x in js] == [2, 0, 2]


def _stacks(hetero: bool):
    """Client-stacked optimizer states of the qwen smoke trainables with
    random positive ṽ and m per client and, with ``hetero``, a random
    orthonormal basis per client."""
    jcfg = jsmoke(jget_config(rp.QWEN))
    _, _, st = _jax_state(jcfg, rp.SPEC)
    stacked = _np(jgal.stack_opt_state(st, rp.C, copy=True))
    rng = np.random.default_rng(5)

    def fill(blk):
        basis = blk.basis
        if hetero:
            basis = np.linalg.qr(rng.normal(size=basis.shape))[0]
        return type(blk)(basis=basis.astype(np.float32),
                         m=rng.normal(size=blk.m.shape).astype(np.float32),
                         v=np.abs(rng.normal(size=blk.v.shape))
                         .astype(np.float32))

    g = jgal.galore_state_of(stacked)
    g = g._replace(blocks=jax.tree_util.tree_map(
        fill, g.blocks, is_leaf=lambda x: isinstance(x,
                                                     jgal.GaloreBlockState)))
    return jgal.replace_galore_state(stacked, g)


SYNCS = [("ajive", True, True), ("avg", True, True),
         ("avg_svd", True, True), ("ajive", False, True),
         ("ajive", True, False), ("avg", True, False)]
# ṽ after 𝒮: 1e-5 on a shared basis; over diverged random bases AJIVE's
# transfer Grams and Λ^{-1/2} read 2.3e-5 (ROADMAP Queue 3 ad, j)
SYNC_TOL = {True: 1e-5, False: 1e-4}


@pytest.mark.parametrize("protocol,factored,shared", SYNCS)
def test_sync_client_states_matches_jax(protocol, factored, shared):
    stacked = _stacks(hetero=not shared)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    kw = dict(factored=factored, bases_shared=shared)
    jout = jax.jit(functools.partial(jsteps.sync_client_states,
                                     n_clients=rp.C, state_sync=protocol,
                                     **kw))(
        jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(w))
    tout = tsteps.sync_client_states(opt_state_from_jax(stacked, "cpu"),
                                     torch.as_tensor(w), rp.C, protocol, **kw)
    jg, tg = jgal.galore_state_of(jout), tgal.galore_state_of(tout)
    assert tg.seed == int(jg.seed) == rp.SPEC.get("seed", 0) + 1
    jv = jax.tree_util.tree_leaves(jgal.extract_projected_v(jg))
    tv = tree.tree_leaves(tgal.extract_projected_v(tg))
    assert len(tv) == len(jv) == 7
    for got, want in zip(tv, jv):
        assert got.shape == want.shape
        assert rp.rel(got.numpy(), want) <= SYNC_TOL[shared]


def test_prefill_and_decode_steps_match_jax():
    jcfg = jsmoke(jget_config(rp.QWEN))
    tcfg = smoke_variant(get_config(rp.QWEN))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np(jparams), "cpu")
    toks = rp.batches(jcfg.vocab_size, 4)["tokens"][:, 0, 0]    # (3, 8)
    cache = 16
    jl, js = jax.jit(jsteps.make_prefill_step(jcfg, cache))(
        jparams, jnp.asarray(toks))
    tl, ts = tsteps.make_prefill_step(tcfg, cache)(tparams,
                                                   torch.as_tensor(toks))
    assert rp.rel(tl.numpy(), jl) <= 1e-5
    # decode from the same state: JAX's carried across
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jd, _ = jax.jit(jsteps.make_decode_step(jcfg))(jparams, jnp.asarray(nxt),
                                                  js)
    td, _ = tsteps.make_decode_step(tcfg)(
        tparams, torch.as_tensor(nxt), decode_state_from_jax(_np(js), "cpu"))
    assert rp.rel(td.numpy(), jd) <= 1e-4
    assert int(ts.t) == int(js.t) == toks.shape[1]
