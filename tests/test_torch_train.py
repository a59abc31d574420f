"""Port parity: the training CLI ``repro_torch.launch.train`` against
``repro.launch.train`` (``--smoke``, the port on ``--device cpu``), both
starting from the same JAX-initialised params (the port's ``init_params``
replaced by a carry-across of JAX's for the test), and one FedGaLore
round of the vit backbone on the patch task, whose batches carry the
frontend's embeddings.

Tolerances (ROADMAP Queue 3 e: round 0's RSVD refresh is sensitive to
round-off in both packages): per-round local and validation losses
≤ 1e-5 of their size and validation accuracy equal, for FedGaLore on
qwen1.5's smoke model, the LoRA method ``fedit`` (no RSVD) on the
sinusoidal paper-roberta-like and the vit round at rank 2. FedGaLore at
rank 4 on the two sinusoidal backbones is held to 1e-3 of the loss
(``RSVD_TOL``): their RSVD bases sit on small spectral gaps, so fp32
round-off moves the update. Measured on the CPU: roberta's CLI run parts
from JAX's by 1.1e-5 / 3.5e-4 (local, rounds 0 / 1) and 4.3e-4 / 4.2e-4
(validation), while JAX against itself, with its initial params scaled
by 1 + 1e-7·N(0, 1), parts by 2.7e-4 / 3.6e-4 in validation; the vit
round parts by 2.0e-5 (local) and 1.1e-5 (validation) against JAX's own
1.3e-4, and by up to 5e-4 with other data drawn. A port run of
roberta at lr 3.3e-3 against JAX's 3e-3 parts by 8.3e-3 to 1.1e-2, so
the bound still fails a wrong step. The port's per-round
checkpoints are read back by the JAX package's ``restore``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.fed import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import FederatedBatcher as JBatcher
from repro.data import patch_classification as jpatch
from repro.launch import train as jtrain
from repro.launch.steps import galore_target_fn as jtarget
from repro.models import model as jmodel
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.fed import FedConfig, FedEngine
from repro_torch.data import FederatedBatcher, patch_classification
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax

LOSS_TOL = 1e-5
RSVD_TOL = 1e-3
ARGS = ["--smoke", "--rounds", "2", "--clients", "2", "--local-steps", "2",
        "--batch", "8", "--seq", "16", "--examples", "256", "--classes", "4",
        "--rank", "4", "--alpha", "0.5", "--lr", "3e-3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size tensors gain nothing from torch's intra-op pool, and
    beside the JAX compiles of parallel test workers its idle threads only
    compete for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=LOSS_TOL):
    return abs(got - want) <= tol * max(1.0, abs(want))


@pytest.mark.parametrize("arch,method,tol", [
    ("qwen1.5-0.5b", "fedgalore", LOSS_TOL),
    ("paper-roberta-like", "fedit", LOSS_TOL),
    ("paper-roberta-like", "fedgalore", RSVD_TOL)])
def test_train_cli_matches_jax(arch, method, tol, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    jcfg = jsmoke(jget_config(arch))
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(tmodel, "init_params",
                        lambda cfg, seed, device: params_from_jax(jparams,
                                                                  device))
    args = ARGS + ["--arch", arch, "--method", method]
    want = jtrain.main(args)
    got = ttrain.main(args + ["--device", "cpu", "--ckpt-dir", ckpt])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert _close(g["local_loss"], w["local_loss"], tol), (g, w)
        assert _close(g["val_loss"], w["val_loss"], tol), (g, w)
        assert g["val_acc"] == w["val_acc"]
    # the port's checkpoint of the last round, read by the JAX package
    assert jckpt.latest_step(ckpt) == 1
    template = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    restored = jckpt.restore(ckpt, 1, template)
    batch = {"tokens": jnp.zeros((1, 4), jnp.int32),
             "labels": jnp.ones((1, 4), jnp.int32)}
    assert np.isfinite(float(jmodel.loss_fn(restored, jcfg, batch)))


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(ARGS)


@pytest.mark.parametrize("method,rank,tol", [("fedit", 2, LOSS_TOL),
                                             ("fedgalore", 2, LOSS_TOL),
                                             ("fedgalore", 4, RSVD_TOL)])
def test_vit_round_with_embeds_matches_jax(method, rank, tol):
    """One round of paper-vit-like's smoke variant on
    ``patch_classification`` (16 patch embeddings, then 4 text tokens, the
    last labelled): the batches carry ``embeds`` through ``FedEngine``;
    per-step and evaluation losses within ``tol`` of their size, for LoRA
    (``fedit``) and for ``fedgalore``'s round 0 (transient lift, RSVD
    refresh, hetero 𝒜 and 𝒮). With one labelled token per example, a
    rank-4 RSVD basis of these gradients sits on a small spectral gap and
    carries fp32 round-off into the update (ROADMAP Queue 3 e), so rank 4
    is held to ``RSVD_TOL`` and rank 2 (measured 1.7e-6; the LoRA round
    ≤ 1e-7) to 1e-5."""
    jcfg = jsmoke(jget_config("paper-vit-like"))
    tcfg = smoke_variant(get_config("paper-vit-like"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    args = (128, 4, jcfg.frontend_tokens, jcfg.d_model, jcfg.vocab_size)
    jb = JBatcher(jpatch(*args, seed=1), 2, 8, alpha=0.5)
    tb = FederatedBatcher(patch_classification(*args, seed=1), 2, 8,
                          alpha=0.5)
    kw = dict(method=method, rank=rank, lr=3e-3, local_steps=2)
    je = JFedEngine(JFedConfig(**kw),
                    loss_fn=lambda p, b: jmodel.loss_fn(p, jcfg, b),
                    params=jparams, target_fn=jtarget(jcfg))
    te = FedEngine(FedConfig(**kw),
                   loss_fn=lambda p, b: tmodel.loss_fn(p, tcfg, b),
                   params=tparams, target_fn=galore_target_fn(tcfg))
    jbatch, tbatch = jb.round_batches(2), tb.round_batches(2)
    assert tbatch["embeds"].shape == (2, 2, 8, jcfg.frontend_tokens,
                                      jcfg.d_model)
    jm = je.run_round({k: jnp.asarray(v) for k, v in jbatch.items()})
    tm = te.run_round(tbatch)
    jl, tl = np.asarray(jm["local_loss"]), tm["local_loss"].numpy()
    assert np.all(np.abs(tl - jl) <= tol * np.maximum(1.0, np.abs(jl)))
    ev = jb.eval_batch(16)
    want = float(jmodel.loss_fn(je.global_params(), jcfg,
                                {k: jnp.asarray(v) for k, v in ev.items()}))
    assert _close(te.evaluate(ev), want, tol)
