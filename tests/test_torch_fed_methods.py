"""Port parity: every method of ``METHODS`` — the LoRA baselines, FedAvg on
dense leaves and the GaLore methods — through
``repro_torch.core.fed.FedEngine`` against ``repro.core.fed.FedEngine``.

Two problems:

* JAX's own ``_problem`` of ``tests/test_fed_methods.py`` (a two-layer
  tanh regression, batches as a tuple ``(x, y)``), the params carried
  across: all ten methods for two rounds, with the reference's
  configuration of that test (rank 4, lr 3e-2, T = 5, clip 10). Each
  learns, and matches JAX: per-step losses and the merged global params
  ≤1e-5, the trainables (LoRA pairs, dense leaves) ≤1e-5 of their
  scale, LoRA-Fair's ≤1e-4: its refinement solves against Ā Āᵀ, and the
  (16, 4) leaf's square rank-4 A gives that Gram a condition number of
  ~1e3, which multiplies the ulp-level difference of the mean lift
  (measured 3.2e-5, 2.3e-5 and 6.0e-5 after rounds 1-3 on B̄', every
  other factor ≤4.3e-7). FR-LoRA's rank-r truncation of a rank ≤ C·r delta sits on the
  gap between the r-th and (r+1)-th singular values (ROADMAP Queue 3
  e): its adapters are compared through ``B·A`` (sign-free) and the base
  it writes.
* The qwen1.5 smoke model, set up as ``test_torch_fed.py`` sets it up
  (C = 4, T = 2, rank 4, batch 8 × 16, fp32): ``fedit``, ``flora``,
  ``fr_lora`` and ``fedavg_full`` for two rounds against JAX's default
  round. Per-step losses ≤1e-5, FedAvg-Full's ≤5e-5. The leaves are
  compared by what the rounds changed, D = leaf − start, as
  ‖D_port − D_jax‖_F / ‖D_jax‖_F over the trainables (FLoRA's and
  FR-LoRA's as B·A) and over the base they write, within
  ``QWEN_DELTA_TOL``. The cause of both bounds: Adam's step m̂/(√v̂ + ε)
  on a gradient entry at round-off level (|g| ≲ ε = 1e-8, where the two
  packages' gradients differ by ~1e-9) moves that entry by up to ~0.1 of
  the lr — measured on FedAvg-Full's first step, 0.081 at g = −5.1e-9
  (JAX) against −3.4e-9 (port). Dense Adam over every m×n entry
  (FedAvg-Full) meets many such entries; the LoRA factors' gradients are
  sums over a dimension and meet few. Measured after two rounds: D
  differs by 2.5e-5 (FedIT), 1.0e-4 (FLoRA's base), 4.3e-5 and 1.2e-4
  (FR-LoRA's B·A and base) and 6.2e-4 (FedAvg-Full); losses by ≤1e-6,
  FedAvg-Full's by 2.3e-5.

The eager oracle round and the port's factored round against its own
dense-client round are ``test_torch_fed_eager.py``'s.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from threadpoolctl import threadpool_limits

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import fed as jfed
from repro.data import FederatedBatcher as JBatcher
from repro.data import seq_classification as jseq
from repro.launch.steps import galore_target_fn as jtarget
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import fed as tfed
from repro_torch.core import lora as tlora
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree
from test_fed_methods import _problem

ROUNDS = 2
C, T, BATCH, SEQ = 4, 2, 8, 16
QWEN_METHODS = ["fedit", "flora", "fr_lora", "fedavg_full"]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _np_leaves(jtree, ttree):
    j = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]
    t = [x.detach().cpu().numpy() for x in tree.tree_leaves(ttree)]
    return j, t


def _tloss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
    out = h @ p["l2"]["w"] + p["l2"]["b"]
    return torch.mean((out - y) ** 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread (the LAPACK behind SciPy's and
    JAX's CPU SVDs): beside the other test workers, idle threads of a
    multi-threaded pool only compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    jparams, jloss, batches = _problem()
    tparams = tree.tree_map(lambda x: torch.from_numpy(np.array(x)),
                            jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, jloss, batches, tparams


def _cfg_kw(method):
    return dict(method=method, rank=4, lr=3e-2, local_steps=5,
                clip_norm=10.0)


def test_method_table_matches_the_reference():
    assert set(tfed.METHODS) == set(jfed.METHODS)
    for name, spec in jfed.METHODS.items():
        t = tfed.METHODS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(spec)
    assert tfed.FedConfig().lora_scale == jfed.FedConfig().lora_scale == 2.0


@pytest.mark.parametrize("method", sorted(jfed.METHODS))
def test_method_matches_jax_and_learns(problem, method):
    jparams, jloss, batches, tparams = problem
    je = jfed.FedEngine(jfed.FedConfig(**_cfg_kw(method)), jloss, jparams)
    te = tfed.FedEngine(tfed.FedConfig(**_cfg_kw(method)), _tloss, tparams)
    eval_b = (batches[0][0, 0], batches[1][0, 0])
    teval = tuple(torch.from_numpy(np.array(x)) for x in eval_b)
    l0 = float(_tloss(te.global_params(), teval))
    assert abs(l0 - float(jloss(je.global_params(), eval_b))) <= 1e-6
    for _ in range(ROUNDS):
        jm = je.run_round(batches)
        tm = te.run_round(batches)          # the tuple batch, as jax arrays
        assert tm["local_loss"].shape == (4, 5)
        assert np.max(np.abs(tm["local_loss"].numpy()
                             - np.asarray(jm["local_loss"]))) <= 1e-5
    jg, tg = _np_leaves(je.global_params(), te.global_params())
    for got, want in zip(tg, jg):
        assert np.max(np.abs(got - want)) <= 1e-5
    if te.spec.aggregation == "lift_refac":
        for ja, ta in zip(
                jax.tree_util.tree_leaves(je.global_trainable,
                                          is_leaf=lambda x: hasattr(x, "b")),
                tree.tree_leaves(te.global_trainable,
                                 is_leaf=tlora.is_lora_pair)):
            assert _rel((ta.b @ ta.a).numpy(),
                        np.asarray(ja.b @ ja.a)) <= 1e-5
    else:
        jt, tt = _np_leaves(je.global_trainable, te.global_trainable)
        assert len(jt) == len(tt)
        tol = 1e-4 if method == "lora_fair" else 1e-5
        for got, want in zip(tt, jt):
            assert _rel(got, want) <= tol
    jf, tf = _np_leaves(je.frozen, te.frozen)
    for got, want in zip(tf, jf):
        assert np.max(np.abs(got - want)) <= 1e-5
    assert (te.synced_v is None) == (je.synced_v is None)
    l1 = te.evaluate(eval_b)
    assert np.isfinite(l1) and l1 < l0, f"{method}: {l0} -> {l1}"


def test_lora_trainables_are_jax_draws(problem):
    """The round-start adapters: A from ``fold_in(PRNGKey(seed), i)``, i
    the leaf's JAX flatten index, B zero; FLoRA's fresh adapters from
    ``PRNGKey(seed + 1000 + round)``."""
    jparams, jloss, _, tparams = problem
    je = jfed.FedEngine(jfed.FedConfig(**_cfg_kw("flora")), jloss, jparams)
    te = tfed.FedEngine(tfed.FedConfig(**_cfg_kw("flora")), _tloss, tparams)
    jt, tt = _np_leaves(je.global_trainable, te.global_trainable)
    assert len(jt) == len(tt) == 4
    for got, want in zip(tt, jt):
        assert np.max(np.abs(got - want)) <= 1e-7
    jt, tt = _np_leaves(je._fresh_adapters(3), te._fresh_adapters(3))
    for got, want in zip(tt, jt):
        assert np.max(np.abs(got - want)) <= 1e-7


# ------------------------------------------------------ the qwen smoke model --

@pytest.fixture(scope="module")
def qwen():
    jcfg = jsmoke(jget_config("qwen1.5-0.5b"))
    tcfg = smoke_variant(get_config("qwen1.5-0.5b"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, tcfg, jparams, tparams


def _qwen_engines(qwen, **kw):
    jcfg, tcfg, jparams, tparams = qwen
    fkw = dict(rank=4, lr=3e-3, local_steps=T, **kw)
    je = jfed.FedEngine(jfed.FedConfig(**fkw),
                        loss_fn=lambda p, b: jmodel.loss_fn(p, jcfg, b),
                        params=jparams, target_fn=jtarget(jcfg))
    te = tfed.FedEngine(tfed.FedConfig(**fkw),
                        loss_fn=lambda p, b: tmodel.loss_fn(p, tcfg, b),
                        params=tparams, target_fn=galore_target_fn(tcfg))
    jb = JBatcher(jseq(256, 4, SEQ, jcfg.vocab_size), C, BATCH, alpha=0.5)
    tb = FederatedBatcher(seq_classification(256, 4, SEQ, tcfg.vocab_size),
                          C, BATCH, alpha=0.5)
    return je, te, jb, tb


def _change_rel(got, want, start):
    """‖D_got − D_want‖_F / ‖D_want‖_F with D = leaf − start."""
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum((w - s) ** 2)) for w, s in zip(want, start))
    return (num / max(den, 1e-30)) ** 0.5


def _products(jtrain, ttrain):
    """(JAX, port) lists of B·A per adapted leaf."""
    jl = jax.tree_util.tree_leaves(jtrain, is_leaf=lambda x: hasattr(x, "b"))
    tl = tree.tree_leaves(ttrain, is_leaf=tlora.is_lora_pair)
    return ([np.asarray(j.b @ j.a) for j in jl],
            [(t.b @ t.a).numpy() for t in tl])


QWEN_LOSS_TOL = {"fedavg_full": 5e-5}
QWEN_DELTA_TOL = {"fedit": 1e-4, "flora": 3e-4, "fr_lora": 3e-4,
                  "fedavg_full": 2e-3}


@pytest.mark.parametrize("method", QWEN_METHODS)
def test_qwen_smoke_round_matches_jax(qwen, method):
    je, te, jb, tb = _qwen_engines(qwen, method=method)
    lifts = method in ("flora", "fr_lora")
    jstart, _ = (_products(je.global_trainable, te.global_trainable) if lifts
                 else _np_leaves(je.global_trainable, te.global_trainable))
    fstart, _ = _np_leaves(je.frozen, te.frozen)
    for _ in range(ROUNDS):
        jbatch, tbatch = jb.round_batches(T), tb.round_batches(T)
        jm = je.run_round({k: jnp.asarray(v) for k, v in jbatch.items()})
        tm = te.run_round(tbatch)
        assert np.max(np.abs(tm["local_loss"].numpy()
                             - np.asarray(jm["local_loss"]))) \
            <= QWEN_LOSS_TOL.get(method, 1e-5)
    jt, tt = (_products(je.global_trainable, te.global_trainable) if lifts
              else _np_leaves(je.global_trainable, te.global_trainable))
    assert len(jt) == len(tt) == (7 if method in ("fedavg_full", "flora",
                                                  "fr_lora") else 14)
    for got, want in zip(tt, jt):
        assert got.dtype == want.dtype and got.shape == want.shape
    tol = QWEN_DELTA_TOL[method]
    if method != "flora":                   # FLoRA's adapters restart at B = 0
        assert _change_rel(tt, jt, jstart) <= tol
    jf, tf = _np_leaves(je.frozen, te.frozen)
    if lifts:
        assert _change_rel(tf, jf, fstart) <= tol
    else:
        assert all(np.array_equal(a, b) for a, b in zip(tf, fstart))
