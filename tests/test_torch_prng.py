"""Port parity: ``repro_torch.utils.prng`` (threefry-2x32 in torch integer
ops) against ``jax.random`` under jax's ``jax_threefry_partitionable``
layout, and the seeded bases built on it.

Raw uint32 bits must be equal. ``normal`` and the seeded orthonormal bases
are held to 1e-6: the port's erfinv is XLA's float32 polynomial term for
term, but torch's ``log1p``/``sqrt`` may round one ulp apart from XLA's.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import projector as jproj
from repro_torch.core import projector as tproj
from repro_torch.utils import prng

SEEDS = [0, 1, 42, 2 ** 31 + 7]
SHAPES = [(1,), (7,), (64, 12), (2, 256, 4), (3, 1024, 8)]


def _jkey(seed):
    return jax.random.PRNGKey(np.uint32(seed))


def _np(key_or_bits):
    return np.asarray(key_or_bits).astype(np.int64)


def test_partitionable_layout_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal(seed):
    jk, tk = _jkey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_np(jk), tk.numpy())
    for data in (0, 1, 5, 2 ** 32 - 1):
        assert np.array_equal(_np(jax.random.fold_in(jk, np.uint32(data))),
                              prng.fold_in(tk, data).numpy())
    for num in (2, 5):
        assert np.array_equal(_np(jax.random.split(jk, num)),
                              prng.split(tk, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_equal(seed, shape):
    jk, tk = _jkey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_np(jax.random.bits(jk, shape)),
                          prng.bits(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          prng.uniform(tk, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_close(seed):
    shape = (256, 1024)
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(_jkey(seed), shape))
    assert np.max(np.abs(got - want)) <= 1e-6


def test_normal_batched_over_keys():
    jkeys = jax.random.split(_jkey(3), 6).reshape(2, 3, 2)
    want = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (40, 4))))(jkeys))
    got = prng.normal(torch.from_numpy(_np(jkeys)), (40, 4)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-6


def test_erfinv_polynomial_beats_torch_erfinv():
    """The reason for the transcription: torch.erfinv on JAX's own uniforms
    misses jax.random.normal by more than the polynomial does."""
    shape = (200_000,)
    u = prng.uniform(prng.PRNGKey(11), shape, float(np.nextafter(
        np.float32(-1), np.float32(0))), 1.0)
    want = np.asarray(jax.random.normal(_jkey(11), shape))
    poly = np.abs(prng.normal(prng.PRNGKey(11), shape).numpy() - want).max()
    naive = np.abs((np.float32(np.sqrt(2)) * torch.erfinv(u)).numpy()
                   - want).max()
    assert poly <= 1e-6 < naive


@pytest.mark.parametrize("dim,rank", [(32, 4), (256, 8), (1024, 8)])
def test_random_basis_close(dim, rank):
    for seed in (0, 9):
        want = np.asarray(jproj.random_basis(seed, dim, rank))
        got = tproj.random_basis(seed, dim, rank).numpy()
        assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("seed,refresh,block", [(0, 0, 0), (3, 1, 5),
                                                (2 ** 31, 7, 6)])
def test_seeded_block_key_chains_equal(seed, refresh, block):
    jk = jproj.seeded_block_key(jnp.uint32(seed), jnp.uint32(refresh), block)
    tk = tproj.seeded_block_key(seed, refresh, block)
    assert np.array_equal(_np(jk), tk.numpy())
    assert np.array_equal(_np(jproj.stacked_keys(jk, 24)),
                          tproj.stacked_keys(tk, 24).numpy())
    ids = jnp.asarray([0, 2, 5], jnp.uint32)
    jks = jax.vmap(lambda b: jproj.seeded_block_key(
        jnp.uint32(seed), jnp.uint32(refresh), b))(ids)
    tks = tproj.seeded_block_key(seed, refresh, torch.tensor([0, 2, 5]))
    assert np.array_equal(_np(jks), tks.numpy())
    want = np.asarray(jproj.random_basis_nd(
        jax.vmap(lambda k: jproj.stacked_keys(k, 2))(jks), 48, 4))
    got = tproj.random_basis(tproj.stacked_keys(tks, 2), 48, 4).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (8, 512), (1, 151936)])
def test_gumbel_close(seed, shape):
    """jax's default (mode "low") Gumbel noise: the uniform bits are equal,
    and torch's log rounds at most a few ulp from XLA's, so the noise
    agrees to 2e-6 of max(1, |g|)."""
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.gumbel(_jkey(seed), shape))
    assert got.dtype == want.dtype == np.float32
    assert np.all(np.abs(got - want) <= 2e-6 * np.maximum(1.0, np.abs(want)))


def _sampling_logits(seed):
    """(8, 512) rows: Gaussian logits, an all-equal row, a row whose two
    largest logits tie exactly, a row with -inf entries, a peaked row and
    a row of large magnitude."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    x[1] = 0.25
    x[2, [17, 300]] = 4.0
    x[3, ::3] = -np.inf
    x[4, 99] = 30.0
    x[5] *= 1e3
    return x


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_equal(seed):
    """Token for token JAX's draw, ties and masked entries included; the
    tied pair of row 2 is taken on both sides by the same noise."""
    logits = _sampling_logits(seed)
    for temp in (1.0, 0.8):
        want = np.asarray(jax.random.categorical(
            _jkey(seed), jnp.asarray(logits / temp)))
        got = prng.categorical(prng.PRNGKey(seed),
                               torch.from_numpy(logits / temp))
        assert got.dtype == torch.int64 and got.shape == (8,)
        assert np.array_equal(got.numpy(), want)
    assert int(got[4]) == 99


@pytest.mark.parametrize("seed", [0, 7])
def test_categorical_vocab_wide_and_batched_axis(seed):
    """A qwen-vocab row (151,936 logits) and a draw along axis 0."""
    rng = np.random.default_rng(seed)
    wide = rng.standard_normal((2, 151936)).astype(np.float32)
    key = jax.random.fold_in(_jkey(seed), 3)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(wide)))
    got = prng.categorical(prng.fold_in(prng.PRNGKey(seed), 3),
                           torch.from_numpy(wide))
    assert np.array_equal(got.numpy(), want)
    cols = rng.standard_normal((64, 5)).astype(np.float32)
    want = np.asarray(jax.random.categorical(_jkey(seed), jnp.asarray(cols),
                                             axis=0))
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(cols),
                           axis=0)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="float32"):
        prng.categorical(prng.PRNGKey(seed), torch.zeros(2, 4,
                                                         dtype=torch.bfloat16))
