"""Port parity: FedEngine rounds of the MLA + MoE family —
``repro_torch.core.fed.FedEngine`` against ``repro.core.fed.FedEngine``
on the deepseek-v2-236b smoke model (2 layers of MLA with a 4-expert
top-2 MoE and a shared expert, d 256, fp32), from the JAX-initialised
params carried across (``models/convert.py::params_from_jax``) and the
same batches from both packages' ``FederatedBatcher``.

Set-up and tolerances as ``test_torch_fed.py``'s (ROADMAP Queue 3 e): C =
4 clients, T = 2 local steps, rank 4, batch 8 × seq 16; per-step losses
≤ 1e-5, the global trainable leaves ≤ 1e-4 of their scale and the synced
ṽ ≤ 3e-4 (round 0's compared lifted on each package's client-0 basis).
Cases: two ``fedgalore`` rounds (round 0 the transient lift with its
RSVD refresh, round 1 the lift-free read through q_a, q_b, kv_a, kv_b
and wo); the port's lift-free round 1 against its own ``lift_free=False``
round 1; one lift-free round at ``attn_chunk`` 8 on seq 16, where MLA
expands ``kv_b`` once for each visited (query chunk, key chunk) pair and
both packages' norm probes sum over those uses; the number of those
reads; one ``fedit`` round; and the training CLI on the smoke model.

Each JAX engine starts from a zero synced ṽ, which round 0 installs as
the fresh state's zeros, so each compiles one round program. Measured
on the CPU: losses ≤ 9.5e-7, leaves ≤ 2.4e-5, ṽ ≤ 4.6e-5 (round 0's,
lifted); the chunked round 9.5e-7, 7.8e-6, 6.5e-6; the lift-free round
1 against ``lift_free=False`` 0, 3.8e-6, 4.6e-6; FedIT's leaves 1.8e-3
(``FEDIT_PARAM_TOL``).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from threadpoolctl import threadpool_limits

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import galore as jgal
from repro.core import projector as jproj
from repro.core.fed import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import FederatedBatcher as JBatcher
from repro.data import seq_classification as jseq
from repro.launch.steps import galore_target_fn as jtarget
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import galore as tgal
from repro_torch.core.fed import FedConfig, FedEngine
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import layers
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree

ARCH = "deepseek-v2-236b"
C, T, BATCH, SEQ, CHUNK = 4, 2, 8, 16, 8
LOSS_TOL, PARAM_TOL, SYNC_TOL = 1e-5, 1e-4, 3e-4
# FedIT's LoRA B leaves start at zero and take Adam steps on gradient
# entries near round-off (ROADMAP Queue 3 v, aa): the port parts from JAX
# by 1.8e-3 of a leaf's scale, JAX from itself by 7.9e-4 under a 1e-7
# relative move of its params.
FEDIT_PARAM_TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread: beside the other test
    workers, idle threads of a multi-threaded pool only compete for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-30))


class _ReadCount:
    """Counts ``layers.lowrank_apply`` calls on a layer of the global
    target leaves of ``engine`` named ``names`` while active (``dense``
    looks the function up at call time); a layer is known by where its
    weight starts."""

    def __init__(self, engine, *names):
        self.n, self.starts = 0, set()
        for path, leaf in tree.tree_flatten_with_path(
                engine.global_trainable)[0]:
            if tree.path_str(path).split("/")[-1] in names:
                self.starts |= {x.data_ptr() for x in leaf}

    def __enter__(self):
        self.orig = layers.lowrank_apply

        def counted(side, x, w, *args):
            self.n += w.data_ptr() in self.starts
            return self.orig(side, x, w, *args)

        layers.lowrank_apply = counted
        return self

    def __exit__(self, *exc):
        layers.lowrank_apply = self.orig
        return False


def smoke_of(arch):
    """Both packages' smoke configs of ``arch`` and its JAX-initialised
    params with their port copy."""
    jcfg = jsmoke(jget_config(arch))
    tcfg = smoke_variant(get_config(arch))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def smoke():
    return smoke_of(ARCH)


def _engines(smoke, jcfg=None, tcfg=None, **kw):
    """Both packages' engines and batchers for FedConfig fields ``kw``."""
    jc, tc, jparams, tparams = smoke
    jcfg, tcfg = jcfg or jc, tcfg or tc
    fkw = dict(rank=4, lr=3e-3, local_steps=T, **kw)
    je = JFedEngine(JFedConfig(**fkw),
                    loss_fn=lambda p, b: jmodel.loss_fn(p, jcfg, b),
                    params=jparams, target_fn=jtarget(jcfg))
    if je._method_syncs():
        je.synced_v = je._zero_synced_template()   # one compile, same round 0
    te = FedEngine(FedConfig(**fkw),
                   loss_fn=lambda p, b: tmodel.loss_fn(p, tcfg, b),
                   params=tparams, target_fn=galore_target_fn(tcfg))
    jb = JBatcher(jseq(256, 4, SEQ, jcfg.vocab_size), C, BATCH, alpha=0.5)
    tb = FederatedBatcher(seq_classification(256, 4, SEQ, tcfg.vocab_size),
                          C, BATCH, alpha=0.5)
    return je, te, jb, tb


def _record(je, te, jm, tm):
    rec = dict(jloss=np.asarray(jm["local_loss"]),
               tloss=tm["local_loss"].numpy(),
               jglobal=[np.asarray(x) for x in
                        jax.tree_util.tree_leaves(je.global_trainable)],
               tglobal=[x.numpy() for x in
                        tree.tree_leaves(te.global_trainable)])
    if te.synced_v is not None:
        rec.update(
            jsync=[np.asarray(x) for x in
                   jax.tree_util.tree_leaves(je.synced_v)],
            tsync=[x.numpy() for x in tree.tree_leaves(te.synced_v)],
            jb0=[np.asarray(b[0]) for b in jax.tree_util.tree_leaves(
                jgal.extract_bases(jgal.galore_state_of(je._client_opt)))],
            tb0=[b[0].numpy() for b in tree.tree_leaves(
                tgal.extract_bases(tgal.galore_state_of(te._client_opt)))])
    return rec


def _rounds(je, te, jb, tb, n, count=None):
    """``n`` rounds of both engines on identical batches; the port's
    rounds inside ``count`` when given."""
    recs = []
    for _ in range(n):
        jbatch, tbatch = jb.round_batches(T), tb.round_batches(T)
        jm = je.run_round({k: jnp.asarray(v) for k, v in jbatch.items()})
        with count or contextlib.nullcontext():
            tm = te.run_round(tbatch)
        recs.append(_record(je, te, jm, tm))
    return recs


def galore_runs(smoke, *names):
    """Two fedgalore rounds of both engines, the reads of the target
    leaves ``names`` in the port's round 1, and the port's own two rounds
    with ``lift_free=False``."""
    je, te, jb, tb = _engines(smoke, method="fedgalore")
    flags = (je._factored, je._lift_free, te._factored, te._lift_free)
    recs = _rounds(je, te, jb, tb, 1)
    count = _ReadCount(te, *names)
    recs += _rounds(je, te, jb, tb, 1, count)
    tf = FedEngine(FedConfig(method="fedgalore", rank=4, lr=3e-3,
                             local_steps=T, lift_free=False),
                   loss_fn=lambda p, b: tmodel.loss_fn(p, smoke[1], b),
                   params=smoke[3], target_fn=galore_target_fn(smoke[1]))
    tb2 = FederatedBatcher(seq_classification(256, 4, SEQ,
                                              smoke[1].vocab_size),
                           C, BATCH, alpha=0.5)
    transient = [tf.run_round(tb2.round_batches(T))["local_loss"].numpy()
                 for _ in range(2)]
    return dict(recs=recs, flags=flags, reads=count.n, transient=dict(
        loss=transient[1],
        leaves=[x.numpy() for x in tree.tree_leaves(tf.global_trainable)],
        sync=[x.numpy() for x in tree.tree_leaves(tf.synced_v)],
        lift_free=tf._lift_free))


@pytest.fixture(scope="module")
def galore(smoke):
    return galore_runs(smoke, "kv_b")


@pytest.fixture(scope="module")
def chunked(smoke):
    """One lift-free round of both engines at attn_chunk CHUNK (round 0
    without the adaptive refresh reads lift-free), kv_b's reads in the
    port's round."""
    jcfg = dataclasses.replace(smoke[0], attn_chunk=CHUNK)
    tcfg = dataclasses.replace(smoke[1], attn_chunk=CHUNK)
    je, te, jb, tb = _engines(smoke, jcfg, tcfg, method="fedgalore",
                              adaptive_refreshes=0)
    count = _ReadCount(te, "kv_b")
    return dict(rec=_rounds(je, te, jb, tb, 1, count)[0], reads=count.n,
                flags=(je._lift_free, te._lift_free))


def test_round_forms_follow_jax(galore, chunked):
    """Both packages build factored, lift-free engines for MLA (no gate
    on MLA in FedEngine), so round 1 reads lift-free in both."""
    assert galore["flags"] == (True, True, True, True)
    assert chunked["flags"] == (True, True)
    assert galore["transient"]["lift_free"] is False


@pytest.mark.parametrize("rnd", [0, 1])
def test_fedgalore_round_matches_jax(galore, rnd):
    rec = galore["recs"][rnd]
    assert rec["tloss"].shape == rec["jloss"].shape == (C, T)
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) == 5
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got, want) <= PARAM_TOL
    for i, (got, want) in enumerate(zip(rec["tsync"], rec["jsync"])):
        if rnd == 0:                      # each on its client-0 basis
            side = ("right" if want.shape[-1] == rec["jb0"][i].shape[-1]
                    else "left")
            want = np.asarray(jproj.project_back(
                jnp.asarray(want), jnp.asarray(rec["jb0"][i]), side))
            got = np.asarray(jproj.project_back(
                jnp.asarray(got), jnp.asarray(rec["tb0"][i]), side))
        assert _rel(got, want) <= SYNC_TOL


def test_lift_free_round_matches_transient_lift(galore):
    """The port's lift-free round 1 against its own ``lift_free=False``
    round 1 from the same round 0."""
    rec, tr = galore["recs"][1], galore["transient"]
    assert np.max(np.abs(rec["tloss"] - tr["loss"])) <= LOSS_TOL
    for got, want in zip(rec["tglobal"], tr["leaves"]):
        assert _rel(got, want) <= PARAM_TOL
    for got, want in zip(rec["tsync"], tr["sync"]):
        assert _rel(got, want) <= SYNC_TOL


def test_chunked_lift_free_round_matches_jax(chunked):
    rec = chunked["rec"]
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert _rel(got, want) <= PARAM_TOL
    for got, want in zip(rec["tsync"], rec["jsync"]):
        assert _rel(got, want) <= SYNC_TOL


def test_kv_b_reads_per_forward(smoke, galore, chunked):
    """kv_b goes through ``lowrank_apply`` once a layer a forward below
    attn_chunk, and once per visited (query chunk, key chunk) pair at it:
    seq 16 on chunks of 8 visits (0, 0), (1, 0), (1, 1)."""
    forwards_layers = C * T * smoke[1].n_layers
    assert galore["reads"] == forwards_layers
    assert chunked["reads"] == 3 * forwards_layers


def test_fedit_round_matches_jax(smoke):
    je, te, jb, tb = _engines(smoke, method="fedit")
    rec = _rounds(je, te, jb, tb, 1)[0]
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) == 10
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.shape == want.shape and _rel(got, want) <= FEDIT_PARAM_TOL


def test_train_cli_smoke():
    """``python -m repro_torch.launch.train --arch deepseek-v2-236b
    --smoke --device cpu --rounds 1`` (port only)."""
    rows = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--rounds", "1"])
    assert len(rows) == 1
    assert all(np.isfinite(rows[0][k])
               for k in ("local_loss", "val_loss", "val_acc"))
