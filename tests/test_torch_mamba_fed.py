"""Port parity: FedEngine rounds of the Mamba / attention hybrid —
``repro_torch.core.fed.FedEngine`` against ``repro.core.fed.FedEngine``
on the jamba-1.5-large-398b smoke model (a Mamba layer with a dense GLU,
then an attention layer with a 4-expert top-2 MoE; d 256, fp32), set up
as ``test_torch_mla_fed.py`` (whose helpers it shares): two ``fedgalore``
rounds (round 1 reads Mamba's in_proj and out_proj, the attention
projections and the GLU lift-free; the plain Mamba scan runs under
autograd), the port's lift-free round 1 against its own
``lift_free=False`` round 1, the number of lift-free reads of the Mamba
projections, one ``fedit`` round, and the training CLI.

Tolerances as ``test_torch_fed.py``'s (ROADMAP Queue 3 e), but for the
synced ṽ, round 1's leaves and the FedIT leaves, measured on the CPU and
recorded as Queue 3 aa: round 0's lifted ṽ parts from JAX's by 8.8e-4;
round 1's leaves by 1.9e-4 and its ṽ by 1.9e-3 (attention's wk and wv,
whose gradients are small in a model with no positions), where the
port's own round 1 moves 6.4e-5 and 1.3e-3 under a 1e-7 relative move
of its params, and JAX's 5.3e-5 and 7.1e-4 under 1e-6; held to 2e-3,
5e-4 and 5e-3. FedIT's leaves part by 9.3e-5, JAX from itself by 9.3e-5
under 1e-7; held to 3e-4. Losses ≤ 4.3e-6; the lift-free round 1
against ``lift_free=False`` 4.8e-7, 2.9e-6, 1.1e-5.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from repro.core import projector as jproj
from repro_torch.launch import train as ttrain
from test_torch_mla_fed import (_engines, _one_thread, _rel,  # noqa: F401
                                _rounds, galore_runs, smoke_of)

ARCH = "jamba-1.5-large-398b"
C, T = 4, 2
LOSS_TOL, PARAM_TOL, SYNC_TOL = 1e-5, 1e-4, 3e-4
ROUND0_SYNC_TOL, ROUND1_PARAM_TOL, ROUND1_SYNC_TOL = 2e-3, 5e-4, 5e-3
FEDIT_PARAM_TOL = 3e-4


@pytest.fixture(scope="module")
def smoke():
    return smoke_of(ARCH)


@pytest.fixture(scope="module")
def galore(smoke):
    return galore_runs(smoke, "in_proj", "out_proj")


def test_round_forms_follow_jax(galore):
    """Both packages build factored, lift-free engines for the hybrid."""
    assert galore["flags"] == (True, True, True, True)
    assert galore["transient"]["lift_free"] is False


@pytest.mark.parametrize("rnd", [0, 1])
def test_fedgalore_round_matches_jax(galore, rnd):
    rec = galore["recs"][rnd]
    param_tol = PARAM_TOL if rnd == 0 else ROUND1_PARAM_TOL
    sync_tol = ROUND0_SYNC_TOL if rnd == 0 else ROUND1_SYNC_TOL
    assert rec["tloss"].shape == rec["jloss"].shape == (C, T)
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) == 9
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got, want) <= param_tol
    for i, (got, want) in enumerate(zip(rec["tsync"], rec["jsync"])):
        if rnd == 0:                      # each on its client-0 basis
            side = ("right" if want.shape[-1] == rec["jb0"][i].shape[-1]
                    else "left")
            want = np.asarray(jproj.project_back(
                jnp.asarray(want), jnp.asarray(rec["jb0"][i]), side))
            got = np.asarray(jproj.project_back(
                jnp.asarray(got), jnp.asarray(rec["tb0"][i]), side))
        assert _rel(got, want) <= sync_tol


def test_lift_free_round_matches_transient_lift(galore):
    """The port's lift-free round 1 against its own ``lift_free=False``
    round 1 from the same round 0."""
    rec, tr = galore["recs"][1], galore["transient"]
    assert np.max(np.abs(rec["tloss"] - tr["loss"])) <= LOSS_TOL
    for got, want in zip(rec["tglobal"], tr["leaves"]):
        assert _rel(got, want) <= PARAM_TOL
    for got, want in zip(rec["tsync"], tr["sync"]):
        assert _rel(got, want) <= SYNC_TOL


def test_mamba_projections_read_lift_free(smoke, galore):
    """Round 1 reads in_proj and out_proj through ``lowrank_apply`` once
    each a Mamba layer a forward."""
    n_mamba = sum(mix == "mamba" for mix, _ in smoke[1].layer_kinds())
    assert n_mamba == 1
    assert galore["reads"] == C * T * 2 * n_mamba


def test_fedit_round_matches_jax(smoke):
    je, te, jb, tb = _engines(smoke, method="fedit")
    rec = _rounds(je, te, jb, tb, 1)[0]
    assert np.max(np.abs(rec["tloss"] - rec["jloss"])) <= LOSS_TOL
    assert len(rec["tglobal"]) == len(rec["jglobal"]) == 18
    for got, want in zip(rec["tglobal"], rec["jglobal"]):
        assert got.shape == want.shape and _rel(got, want) <= FEDIT_PARAM_TOL


def test_train_cli_smoke():
    """``python -m repro_torch.launch.train --arch jamba-1.5-large-398b
    --smoke --device cpu --rounds 1`` (port only)."""
    rows = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--rounds", "1"])
    assert len(rows) == 1
    assert all(np.isfinite(rows[0][k])
               for k in ("local_loss", "val_loss", "val_acc"))
