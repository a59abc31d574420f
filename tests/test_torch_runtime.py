"""Port parity: the federated runtime — ``repro_torch.fedsim.
ShardedFederation`` against ``repro.fedsim.ShardedFederation`` on a
one-device mesh, in each round form (set-up and tolerances:
``torch_runtime_pair.py``).

Cases: the default lift-free round (two rounds: round 1 starts from the
carried moments and the synced ṽ), ``lift_free=False`` (the transient
read), ``factored_clients=False`` (dense per-client copies),
``fused_round=False`` (𝒯𝒜, then 𝒮 as a separate step) and
``factored_sync=False`` (the dense-lift 𝒮). Measured on the CPU: losses
≤ 9.6e-7, leaves ≤ 3.1e-5, stacked states ≤ 3.0e-5 (ROADMAP Queue 3 ad).
Each JAX round compiles once, ≈ 5–14 s; the file takes ≈ 55 s alone.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.galore import GaloreBlockState
from repro_torch.fedsim import ShardedFederation
from repro_torch.fedsim.runtime import mesh_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import TrainSpec
from repro_torch.utils import tree

import torch_runtime_pair as rp

CASES = {"lift_free": ({}, 2), "transient": (dict(lift_free=False), 1),
         "dense_clients": (dict(factored_clients=False), 1),
         "legacy": (dict(fused_round=False), 1),
         "dense_sync": (dict(factored_sync=False), 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (kw, rounds) in CASES.items():
        jf, tf, jcfg, _ = rp.pair(**kw)
        recs = []
        for r in range(rounds):
            with rp.Calls() as calls:
                rec = rp.run_round(jf, tf, rp.batches(jcfg.vocab_size, r))
            rec["calls"] = calls.n
            recs.append(rec)
        out[name] = recs
    return out


@pytest.mark.parametrize("case,rnd", [(c, r) for c, (_, n) in CASES.items()
                                      for r in range(n)])
def test_round_matches_jax(runs, case, rnd):
    rp.assert_matches(runs[case][rnd])


@pytest.mark.parametrize("case", ["lift_free", "legacy"])
def test_default_round_is_lift_free_from_round_0(runs, case):
    """TrainSpec's GaLore config refreshes seeded-random with no adaptive
    steps, so round 0 is lift-free too (the legacy round's local phase as
    well): the low-rank apply on every target matmul, no lift and no
    preconditioner; 𝒮 runs the eigensolver."""
    layers = smoke_variant(get_config(rp.QWEN)).n_layers
    for rec in runs[case]:
        n = rec["calls"]
        assert n.get("liftfree_value_and_grad") == rp.C * rp.T
        assert n.get("lowrank_linear") == rp.C * rp.T * 7 * layers
        assert "lift_client_trainable" not in n
        assert "galore_precond_step" not in n
        assert n.get("batched_small_eigh", 0) > 0


@pytest.mark.parametrize("case", ["transient", "dense_clients"])
def test_other_forms_read_through_the_preconditioner(runs, case):
    """``lift_free=False`` lifts each step and runs the fused
    preconditioner on the 3 shape buckets; the dense-client round runs it
    through ``tx.update``; neither reads lift-free."""
    n = runs[case][0]["calls"]
    if case == "transient":
        assert n.get("lift_client_trainable") == rp.C * rp.T
    assert n.get("galore_precond_step") == rp.C * rp.T * 3
    assert "lowrank_linear" not in n and "liftfree_value_and_grad" not in n


def _port_fed(**kw):
    cfg = smoke_variant(get_config(rp.QWEN))
    return cfg, ShardedFederation(cfg, TrainSpec(**rp.SPEC),
                                  make_host_mesh(1, device="cpu"), rp.C,
                                  **kw)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree.tree_leaves(a.global_trainable),
                   tree.tree_leaves(b.global_trainable)))


def test_run_rounds_is_a_loop_of_rounds():
    cfg, a = _port_fed()
    _, b = _port_fed()
    k = rp.batches(cfg.vocab_size, 7, k_rounds=2)
    out = a.run_rounds(k)
    want = torch.stack([b.run_round(tree.tree_map(lambda x: x[r], k))
                        ["losses"] for r in range(2)])
    assert out["losses"].shape == (2, rp.C, rp.T)
    assert torch.equal(out["losses"], want) and _same(a, b)
    assert a.round_idx == b.round_idx == 2
    st = a.opt_states[1]
    assert (st.count, st.seed) == (2 * rp.T, rp.SPEC.get("seed", 0) + 2)


def test_states_carry_across_rounds():
    """The runtime keeps each client's first moment across rounds and
    installs the synced ṽ in every slot: after a round the (C, …) ṽ rows
    are equal and the m rows differ."""
    cfg, fed = _port_fed()
    fed.run_round(rp.batches(cfg.vocab_size, 0))
    blocks = tree.tree_leaves(
        fed.opt_states[1].blocks,
        is_leaf=lambda x: isinstance(x, GaloreBlockState))
    assert all(torch.equal(b.v[0], b.v[c]) for b in blocks
               for c in range(rp.C))
    assert any(not torch.equal(b.m[0], b.m[1]) for b in blocks)


class _Mesh:
    """The part of a ``DeviceMesh`` the runtime reads."""

    def __init__(self, shape, device_type="cpu"):
        self.shape, self.device_type = shape, device_type

    def size(self):
        return int(np.prod(self.shape))


def test_runtime_refuses_a_mesh_of_more_than_one_device():
    with pytest.raises(ValueError, match="item 12c"):
        mesh_device(_Mesh((2, 1)))
    with pytest.raises(ValueError, match="item 12c"):
        ShardedFederation(
            smoke_variant(get_config(rp.QWEN)), TrainSpec(**rp.SPEC),
            _Mesh((1, 4)), rp.C)
    assert mesh_device(make_host_mesh(1, device="cpu")) == \
        torch.device("cpu")
