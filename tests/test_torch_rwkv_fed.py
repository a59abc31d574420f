"""Port parity: FedGaLore rounds of rwkv6-1.6b — ``repro_torch.core.fed.
FedEngine`` against ``repro.core.fed.FedEngine`` on the rwkv6 smoke model
(2 layers, d 128, d_ff 512, fp32), with the JAX-initialised params
carried across and the same batches from both packages'
``FederatedBatcher``: the default (factored, lift-free) round and the
eager oracle round (``fused_round=False``), two rounds each.

Set-up and tolerances as ``test_torch_fed.py``'s (ROADMAP Queue 3 e): C =
4 clients, T = 2 local steps, rank 4, batch 8 × seq 16; per-step losses
≤ 1e-5, the global trainable leaves ≤ 1e-4 of their scale and the synced
ṽ ≤ 3e-4 (the factored round 0's on client 0's basis, compared lifted;
the eager round's on client 0's end-of-round basis in both packages,
compared as it stands, as ``test_torch_fed_eager.py`` does). Measured on
the CPU: losses ≤ 1.5e-6, leaves ≤ 9.4e-5, ṽ ≤ 2.8e-4 — round 0's RSVD
bases carry fp32 round-off amplified by the spectral gap at the rank, as
for qwen.
"""
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
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree

ARCH = "rwkv6-1.6b"
C, T, BATCH, SEQ, ROUNDS = 4, 2, 8, 16, 2
LOSS_TOL, PARAM_TOL, SYNC_TOL = 1e-5, 1e-4, 3e-4
FORMS = {"factored": {}, "eager": {"fused_round": False}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread (the LAPACK behind both
    packages' CPU SVDs): beside the other test workers, idle threads of a
    multi-threaded pool only compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _bases0(engine, state_of, extract, leaves):
    return [b[0] for b in leaves(extract(state_of(engine._client_opt)))]


@pytest.fixture(scope="module")
def runs():
    """Both engines through ROUNDS rounds of each form on identical
    batches: per round the losses, global leaves, synced ṽ and, for the
    factored round, client 0's bases."""
    jcfg = jsmoke(jget_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    out = {}
    for form, kw in FORMS.items():
        fkw = dict(method="fedgalore", rank=4, lr=3e-3, local_steps=T, **kw)
        je = JFedEngine(JFedConfig(**fkw),
                        loss_fn=lambda p, b: jmodel.loss_fn(p, jcfg, b),
                        params=jparams, target_fn=jtarget(jcfg))
        je.synced_v = je._zero_synced_template()   # one compile, same round 0
        te = FedEngine(FedConfig(**fkw),
                       loss_fn=lambda p, b: tmodel.loss_fn(p, tcfg, b),
                       params=tparams, target_fn=galore_target_fn(tcfg))
        jb = JBatcher(jseq(256, 4, SEQ, jcfg.vocab_size), C, BATCH,
                      alpha=0.5)
        tb = FederatedBatcher(seq_classification(256, 4, SEQ,
                                                 tcfg.vocab_size),
                              C, BATCH, alpha=0.5)
        recs = []
        for _ in range(ROUNDS):
            jbatch, tbatch = jb.round_batches(T), tb.round_batches(T)
            jm = je.run_round({k: jnp.asarray(v) for k, v in jbatch.items()})
            tm = te.run_round(tbatch)
            recs.append(dict(
                jloss=np.asarray(jm["local_loss"]),
                tloss=tm["local_loss"].numpy(),
                jglobal=[np.asarray(x) for x in
                         jax.tree_util.tree_leaves(je.global_trainable)],
                tglobal=[x.numpy() for x in
                         tree.tree_leaves(te.global_trainable)],
                jsync=[np.asarray(x) for x in
                       jax.tree_util.tree_leaves(je.synced_v)],
                tsync=[x.numpy() for x in tree.tree_leaves(te.synced_v)]))
            if form == "factored":
                recs[-1].update(
                    jb0=[np.asarray(x) for x in _bases0(
                        je, jgal.galore_state_of, jgal.extract_bases,
                        jax.tree_util.tree_leaves)],
                    tb0=[x.numpy() for x in _bases0(
                        te, tgal.galore_state_of, tgal.extract_bases,
                        tree.tree_leaves)])
        out[form] = recs
    return out


_IDS = [(form, r) for form in FORMS for r in range(ROUNDS)]


@pytest.mark.parametrize("form,rnd", _IDS)
def test_round_matches_jax(runs, form, rnd):
    rec = runs[form][rnd]
    assert rec["tloss"].shape == rec["jloss"].shape == (C, T)
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) == 8
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got, want) <= PARAM_TOL


@pytest.mark.parametrize("form,rnd", _IDS)
def test_synced_moments_match_jax(runs, form, rnd):
    rec = runs[form][rnd]
    assert len(rec["tsync"]) == len(rec["jsync"]) == 8
    for i, (got, want) in enumerate(zip(rec["tsync"], rec["jsync"])):
        if rnd == 0 and form == "factored":    # compare the lifted moments
            side = ("right" if want.shape[-1] == rec["jb0"][i].shape[-1]
                    else "left")
            want = np.asarray(jproj.project_back(
                jnp.asarray(want), jnp.asarray(rec["jb0"][i]), side))
            got = np.asarray(jproj.project_back(
                jnp.asarray(got), jnp.asarray(rec["tb0"][i]), side))
        assert _rel(got, want) <= SYNC_TOL
