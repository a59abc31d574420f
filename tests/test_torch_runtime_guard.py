"""Port parity: the runtime's participation and defense layer —
``repro_torch.fedsim.ShardedFederation`` against JAX's on a one-device
mesh (set-up and tolerances: ``torch_runtime_pair.py``).

Cases against JAX: ``run_rounds`` over K = 2 rounds with (K, C) masks
(JAX runs its one-round-deep pipelined scan; the port a loop of rounds),
a masked round, a quarantined round with one client's uplink scaled by
1e3, ``robust_agg="trimmed_mean"``, the seeded participation masks and
every refusal JAX's runtime raises. Then the port's own identities, bit
for bit: an all-true mask, an all-ones attack and an honest quarantined
round (``quarantine_zmax`` pinned high, as ``tests/test_robust.py`` pins
it) are the honest unmasked round. Measured on the CPU: losses ≤ 9.6e-7,
leaves ≤ 7.6e-6, stacked states ≤ 2.5e-5 (ROADMAP Queue 3 ad). The file
takes ≈ 45 s alone.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import population as jpop
from repro.fedsim import ShardedFederation as JFed
from repro.launch.mesh import make_host_mesh as jmesh
from repro.launch.steps import TrainSpec as JSpec
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import population as tpop
from repro_torch.fedsim import ShardedFederation
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch import steps as tsteps
from repro_torch.utils import tree

import torch_runtime_pair as rp

MASKS = np.array([[True, False, True], [False, True, True]])
SCALED = np.array([1.0, 1e3, 1.0], np.float32)
PINNED = dict(quarantine=True, quarantine_zmax=50.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    out = {}
    jf, tf, jcfg, _ = rp.pair()
    out["run_rounds_masked"] = rp.run_rounds(
        jf, tf, rp.batches(jcfg.vocab_size, 7, k_rounds=2), masks=MASKS)
    jf, tf, _, _ = rp.pair()
    out["masked"] = rp.run_round(jf, tf, rp.batches(jcfg.vocab_size, 0),
                                 mask=MASKS[0])
    jf, tf, _, _ = rp.pair(**PINNED)
    out["quarantine_attack"] = rp.run_round(
        jf, tf, rp.batches(jcfg.vocab_size, 0), attack=SCALED)
    jf, tf, _, _ = rp.pair(robust_agg="trimmed_mean", robust_trim=0.34)
    out["trimmed_mean"] = rp.run_round(jf, tf,
                                       rp.batches(jcfg.vocab_size, 0))
    return out


@pytest.mark.parametrize("case", ["run_rounds_masked", "masked",
                                  "quarantine_attack", "trimmed_mean"])
def test_guarded_round_matches_jax(runs, case):
    rp.assert_matches(runs[case])


def test_run_rounds_losses_are_per_round(runs):
    assert runs["run_rounds_masked"]["tloss"].shape == (2, rp.C, rp.T)


def _port(**kw):
    """The port's federation alone, from its own seeded weights."""
    cfg = smoke_variant(get_config(rp.QWEN))
    return ShardedFederation(cfg, tsteps.TrainSpec(**rp.SPEC),
                             make_host_mesh(1, device="cpu"), rp.C,
                             state_sync="ajive", **kw), cfg


def _leaves(fed):
    return tree.tree_leaves(fed.global_trainable) + \
        [x for x in tree.tree_leaves(fed.opt_states) if torch.is_tensor(x)]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("kw,call", [
    ({}, dict(mask=np.ones(rp.C, bool))),
    ({}, dict(attack=np.ones(rp.C, np.float32))),
    (PINNED, {}),
], ids=["all_true_mask", "all_ones_attack", "honest_quarantine"])
def test_port_identities_are_the_honest_round(kw, call):
    plain, cfg = _port()
    other, _ = _port(**kw)
    for r in range(2):
        b = rp.batches(cfg.vocab_size, r)
        mp, mo = plain.run_round(b), other.run_round(b, **call)
        assert torch.equal(mp["losses"], mo["losses"])
    assert _equal(plain, other)
    assert other._round_masked is None     # the guarded round never built


def test_quarantine_screens_the_scaled_client():
    """The quarantined round's effective weights (``return_weights``):
    the client whose uplink is scaled by 1e3 carries weight 0, the
    others share the rest."""
    fed, cfg = _port(**PINNED)
    step = tsteps.make_fed_round_step(
        cfg, fed.spec, rp.C, state_sync="ajive", exclude_zero_weights=True,
        quarantine=True, quarantine_zmax=50.0, return_weights=True)
    b = tree.tree_map(torch.as_tensor, rp.batches(cfg.vocab_size, 0))
    w = torch.full((rp.C,), 1.0 / rp.C)
    *_, w_eff = step(fed.global_trainable, fed.frozen, fed.opt_states, b, w,
                     torch.as_tensor(SCALED))
    assert w_eff[1] == 0 and torch.allclose(w_eff[[0, 2]],
                                            torch.full((2,), 0.5))
    *_, w_honest = step(fed.global_trainable, fed.frozen, fed.opt_states, b,
                        w)
    assert torch.equal(w_honest, w)


def test_sample_round_mask_matches_jax():
    kw = dict(dropout_rate=0.5, seed=9)
    jf, tf, _, _ = rp.pair(participation=jpop.ParticipationConfig(**kw))
    tf.participation = tpop.ParticipationConfig(**kw)
    for r in range(4):
        assert np.array_equal(jf.sample_round_mask(r),
                              tf.sample_round_mask(r))
    assert np.array_equal(tf.sample_round_mask(), tf.sample_round_mask(0))


def _zeros():
    return {k: np.zeros((rp.C, rp.T, rp.B, rp.L), np.int32)
            for k in ("tokens", "labels")}


REFUSALS = [
    # (federation kwargs, method, call kwargs, phrase both messages hold)
    (dict(robust_agg="median"), None, {}, "robust_agg"),
    (dict(factored_clients=False, quarantine=True), "run_round", {},
     "factored client round"),
    (dict(factored_clients=False), "run_round",
     dict(attack=np.array([-1.0, 1.0, 1.0], np.float32)),
     "requires the factored"),
    (dict(fused_round=False), "run_round",
     dict(attack=np.array([-1.0, 1.0, 1.0], np.float32)), "fused_round"),
    ({}, "run_round", dict(mask=np.ones(rp.C + 1, bool)), "mask shape"),
    ({}, "run_round", dict(mask=np.zeros(rp.C, bool)), "drops every"),
    ({}, "run_round", dict(attack=np.ones(rp.C + 1, np.float32)),
     "attack shape"),
    (dict(fused_round=False), "run_rounds", {}, "fused_round=True"),
    ({}, "run_rounds", dict(masks=np.ones((3, rp.C), bool)), "masks shape"),
    ({}, "run_rounds", dict(masks=np.array([[True] * rp.C, [False] * rp.C])),
     "drops every"),
]


@pytest.mark.parametrize("kw,method,call,phrase", REFUSALS,
                         ids=[f"{m}-{p}" for _, m, _, p in REFUSALS])
def test_refusals_match_jax(kw, method, call, phrase):
    b = _zeros()
    if method == "run_rounds":
        b = {k: np.stack([v, v]) for k, v in b.items()}

    def attempt(make, batch):
        with pytest.raises(ValueError) as err:
            fed = make()
            if method is not None:
                getattr(fed, method)(batch, **call)
        return str(err.value)

    jmsg = attempt(lambda: JFed(jsmoke(jget_config(rp.QWEN)),
                                JSpec(**rp.SPEC), jmesh(1), rp.C,
                                state_sync="ajive", **kw),
                   {k: jnp.asarray(v) for k, v in b.items()})
    tmsg = attempt(lambda: _port(**kw)[0], b)
    assert phrase in jmsg and phrase in tmsg, (jmsg, tmsg)
