"""The slice of ``jax.random`` the port needs, in torch integer ops:
threefry-2x32, ``PRNGKey``, ``fold_in``, ``split``, 32-bit ``bits``,
``uniform``, ``normal``, and ``gumbel`` / ``categorical`` for sampled
decoding.

The seeded-broadcast protocol rebuilds every projector basis from an
integer seed, so the port has to draw JAX's bits exactly. The layout is
jax 0.9's ``jax_threefry_partitionable = True``: element ``i`` of a draw of
shape ``s`` hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` of its
flat index, and 32-bit ``bits`` are the xor of the two output words.

A key is a ``(..., 2)`` int64 tensor holding two uint32 words; every
uint32 value lives in an int64 and is masked back to 32 bits after each
add and shift, so the same code runs on the CPU and on the card. Floats
are float32. ``normal`` is ``sqrt(2)·erfinv(u)`` with XLA's float32
``ErfInv`` polynomial (two 9-term sets picked by ``w = -log1p(-u²) < 5``),
not ``torch.erfinv``: the latter differs from ``jax.random.normal`` on
most entries by up to ~2e-5, the polynomial by about one ulp. ``gumbel``
is jax's default (``mode="low"``) sampler, ``-log(-log(u))`` with u
uniform on [tiny, 1); torch's ``log`` may round one ulp apart from XLA's,
which moves a ``categorical`` draw only at a near-tie.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all int64 tensors holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): the words
    ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``.
    ``key`` (..., 2); ``data`` an int or an int tensor broadcasting against
    the key's batch dims."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), _u32(data))
    return torch.stack([y1, y2], dim=-1)


def _counters(shape, device):
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash_shape(key: torch.Tensor, shape):
    """Both output words for every flat index of ``shape``, per key:
    ``key`` (..., 2) -> two (..., *shape) tensors."""
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + pad)
    k2 = key[..., 1].reshape(key.shape[:-1] + pad)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (..., num, 2)."""
    y1, y2 = _hash_shape(key, (num,))
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in an int64 tensor),
    batched over the key's leading dims."""
    y1, y2 = _hash_shape(key, shape)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` (``lax.erf_inv``), term for term."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(small, a, b).to(torch.float32)
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


_SQRT2_F32 = float(torch.tensor(math.sqrt(2), dtype=torch.float32))
_NEXT_AFTER_M1 = float(torch.nextafter(torch.tensor(-1.0),
                                       torch.tensor(0.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``, batched over the key's
    leading dims: ``sqrt(2)·erfinv(u)`` with u uniform on
    (nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NEXT_AFTER_M1, 1.0)
    return _SQRT2_F32 * erfinv_f32(u)


_TINY_F32 = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (jax 0.9's default
    ``mode="low"``): ``-log(-log(u))``, u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` for float32 logits:
    the Gumbel-max draw ``argmax(logits + gumbel(key, logits.shape))``
    (ties go to the first index, as in ``jnp.argmax``). JAX draws the
    noise in the logits' dtype; the port's ``uniform`` is float32 only."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical needs float32 logits, got "
                         f"{logits.dtype}")
    return torch.argmax(logits + gumbel(key, logits.shape), dim=axis)
