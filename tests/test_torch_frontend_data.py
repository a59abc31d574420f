"""Port parity: the stub frontends (``repro_torch.models.frontend``), the
sinusoidal positions (``models.layers.sinusoidal_positions``) and the data
functions of the eighth slice (``repro_torch.data``), against the JAX
package on the CPU.

Tolerances. The stubs' fp32 draws within 1e-6 of max(1, |x|) of JAX's
(the port's threefry ``normal`` is one ulp from JAX's, ROADMAP Queue 3 i),
and after the bf16 cast within one bf16 ulp of each entry (a last-place
fp32 difference can cross a rounding boundary). Sinusoidal positions in
fp32 within 2.5e-7 · max(1, position): XLA's and torch's ``exp`` round
some frequencies one ulp apart, and the angle carries that ulp times the
position (ROADMAP Queue 3 t); in bf16 within 2^-8, one bf16 ulp at the
embeddings' scale (|x| ≤ 1; an entry near zero can move by more than
its own ulp, since the fp32 gap spans several of them). The data
functions are numpy on one ``default_rng`` in both packages: equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.data import FederatedBatcher as JBatcher
from repro.data import accuracy_from_logits as jacc
from repro.data import dirichlet_label_partition as jpart
from repro.data import heterogeneity_stats as jhet
from repro.data import markov_lm as jmarkov
from repro.data import patch_classification as jpatch
from repro.models import frontend as jfront
from repro.models import layers as jlayers
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import (FederatedBatcher, accuracy_from_logits,
                              dirichlet_label_partition, heterogeneity_stats,
                              markov_lm, patch_classification)
from repro_torch.models import frontend as tfront
from repro_torch.models import layers as tlayers
from repro_torch.utils import prng


def _bf16_ulp(x):
    """One bf16 ulp of each entry's magnitude (of the smallest normal for
    zero)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ["paper-vit-like", "pixtral-12b"])
@pytest.mark.parametrize("with_class", [False, True])
def test_stub_patch_embeddings(arch, with_class):
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    cls = np.array([0, 7, 1023], np.int32) if with_class else None
    want = jfront.stub_patch_embeddings(
        jax.random.PRNGKey(11), jcfg, 3,
        None if cls is None else jnp.asarray(cls))
    key = prng.PRNGKey(11)
    got = tfront.stub_patch_embeddings(key, tcfg, 3, cls)
    got32 = tfront._patch_fp32(key, tcfg, 3, cls)
    # the reference's own fp32 draw, before its bf16 cast
    want32 = jax.random.normal(jax.random.PRNGKey(11),
                               (3, jcfg.frontend_tokens, jcfg.d_model))
    if cls is not None:
        protos = jax.random.normal(jax.random.PRNGKey(7),
                                   (1024, jcfg.d_model))
        want32 = want32 + 2.0 * protos[cls][:, None, :]
    want32 = np.asarray(want32)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.all(np.abs(got32.numpy() - want32)
                  <= 1e-6 * np.maximum(1.0, np.abs(want32)))
    assert np.all(np.abs(_np(got) - _np(want)) <= _bf16_ulp(_np(want)))


def test_stub_frame_embeddings():
    jcfg = jsmoke(jget_config("musicgen-medium"))
    tcfg = smoke_variant(get_config("musicgen-medium"))
    want = jfront.stub_frame_embeddings(jax.random.PRNGKey(5), jcfg, 2, 9)
    got = tfront.stub_frame_embeddings(prng.PRNGKey(5), tcfg, 2, 9)
    got32 = tfront._frame_fp32(prng.PRNGKey(5), tcfg, 2, 9)
    want32 = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                          (2, 9, jcfg.d_model)))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 256)
    assert np.all(np.abs(got32.numpy() - want32)
                  <= 1e-6 * np.maximum(1.0, np.abs(want32)))
    assert np.all(np.abs(_np(got) - _np(want)) <= _bf16_ulp(_np(want)))


@pytest.mark.parametrize("d_model", [256, 768, 1536])
def test_sinusoidal_positions(d_model):
    pos = np.arange(2048, dtype=np.int32)
    want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), d_model))
    got = tlayers.sinusoidal_positions(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (2048, d_model)
    tol = 2.5e-7 * np.maximum(1.0, pos)[:, None]
    assert np.all(np.abs(got.numpy() - want) <= tol)
    wb = _np(jnp.asarray(want).astype(jnp.bfloat16))
    assert np.max(np.abs(_np(got.bfloat16()) - wb)) <= 2.0 ** -8
    # per-slot (B, 1) positions, the decode step's layout
    slots = np.array([[0], [5], [1999]], np.int32)
    want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(slots),
                                                   d_model))
    got = tlayers.sinusoidal_positions(torch.from_numpy(slots), d_model)
    assert got.shape == (3, 1, d_model)
    assert np.all(np.abs(got.numpy() - want)
                  <= 2.5e-7 * np.maximum(1.0, slots)[..., None])


def test_markov_lm_equal():
    want = jmarkov(40, 3, 12, 32, seed=4)
    got = markov_lm(40, 3, 12, 32, seed=4)
    for f in ("tokens", "labels", "class_ids"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.embeds is None and got.tokens.dtype == np.int32


def test_patch_classification_and_accuracy_equal():
    want = jpatch(24, 5, 196, 32, 1000, seed=2)
    got = patch_classification(24, 5, 196, 32, 1000, seed=2)
    for f in ("tokens", "labels", "class_ids", "embeds"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.embeds.dtype == np.float32 and got.embeds.shape == \
        (24, 196, 32)
    logits = np.random.default_rng(0).standard_normal((24, 1000))
    assert accuracy_from_logits(logits, got.labels[:, -1]) == \
        jacc(logits, want.labels[:, -1])


def test_heterogeneity_stats_equal():
    labels = np.random.default_rng(1).integers(0, 6, 300)
    parts = jpart(labels, 5, 0.5, seed=3)
    tparts = dirichlet_label_partition(labels, 5, 0.5, seed=3)
    assert all(np.array_equal(a, b) for a, b in zip(parts, tparts))
    want, got = jhet(labels, parts), heterogeneity_stats(labels, tparts)
    assert got["mean_tv"] == want["mean_tv"]
    assert got["per_client_tv"] == want["per_client_tv"]
    assert np.array_equal(got["hists"], want["hists"])


def test_batcher_carries_embeds():
    """``round_batches`` (all clients, then a sampled cohort) and
    ``eval_batch`` carry the patch task's embeds, equal to JAX's batches."""
    want_task = jpatch(64, 4, 6, 8, 100, seed=9)
    got_task = patch_classification(64, 4, 6, 8, 100, seed=9)
    jb = JBatcher(want_task, 4, 3, alpha=0.5, seed=1)
    tb = FederatedBatcher(got_task, 4, 3, alpha=0.5, seed=1)
    for _ in range(2):
        clients = tb.sample_clients(2)
        assert clients == jb.sample_clients(2)
        for cl in (None, clients):
            want, got = jb.round_batches(2, cl), tb.round_batches(2, cl)
            assert sorted(got) == ["embeds", "labels", "tokens"]
            assert got["embeds"].shape[:3] == (4 if cl is None else 2, 2, 3)
            for k in want:
                assert np.array_equal(got[k], want[k])
    want, got = jb.eval_batch(10), tb.eval_batch(10)
    assert sorted(got) == ["embeds", "labels", "tokens"]
    for k in want:
        assert np.array_equal(got[k], want[k])
