"""Port parity: the lift-free read — ``kernels.ref.lowrank_linear_ref``
(the plain version of the CUDA ``lowrank_linear``) and the
``models.layers.lowrank_apply`` autograd Function — against the JAX
package's oracle, its Pallas kernel in interpret mode, and ``jax.vjp`` of
its ``lowrank_apply``.

fp32 throughout, tolerance 1e-5 (relative to each output's scale for the
gradients, whose magnitudes grow with the token count). The backward
returns the projected cotangent of R̃ and the exact dense-gradient norm
probe, and no gradient for the base weight.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import lowrank_linear as tll
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers


def _case(rng, side, t, m, n, r, lead=()):
    x = rng.standard_normal(lead + (t, m)).astype(np.float32)
    w = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    bdim = n if side == "right" else m
    basis = np.linalg.qr(rng.standard_normal((bdim, r)))[0].astype(
        np.float32)
    rt = (0.1 * rng.standard_normal((m, r) if side == "right"
                                    else (r, n))).astype(np.float32)
    return x, w, basis, rt


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / max(
        np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("side,m,n", [("right", 96, 64), ("left", 48, 96)])
@pytest.mark.parametrize("t", [1, 200, 300])     # 200, 300: ragged tiles
def test_ref_matches_jax_ref_and_pallas(side, m, n, t):
    rng = np.random.default_rng(0)
    x, w, basis, rt = _case(rng, side, t, m, n, 4, lead=(2,))
    got = tref.lowrank_linear_ref(*map(torch.from_numpy, (x, w, basis, rt)),
                                  0.9, side=side).numpy()
    jargs = tuple(map(jnp.asarray, (x, w, basis, rt)))
    want = np.asarray(jref.lowrank_linear_ref(*jargs, 0.9, side=side))
    kern = np.asarray(jops.lowrank_linear(*jargs, 0.9, side=side))
    assert np.max(np.abs(got - want)) <= 1e-5
    assert np.max(np.abs(got - kern)) <= 1e-5
    via_ops = tops.lowrank_linear(*map(torch.from_numpy, (x, w, basis, rt)),
                                  torch.tensor(0.9), side=side).numpy()
    assert np.max(np.abs(via_ops - want)) <= 1e-5


def _jax_vjp(side, x, w, basis, rt, scale, dy):
    nsq = jnp.zeros([], jnp.float32)

    def f(x_, rt_, nsq_):
        return jlayers.lowrank_apply(side, False, x_, jnp.asarray(w),
                                     jnp.asarray(basis), rt_, nsq_,
                                     jnp.float32(scale))

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(rt), nsq)
    dx, drt, dnsq = vjp(jnp.asarray(dy))
    return y, dx, drt, dnsq


@pytest.mark.parametrize("side,m,n", [("right", 64, 48), ("left", 40, 72)])
@pytest.mark.parametrize("t", [24, 1100])   # 1100: the tiled norm probe
def test_lowrank_apply_grads_match_jax_vjp(side, m, n, t):
    rng = np.random.default_rng(1)
    x, w, basis, rt = _case(rng, side, t, m, n, 4, lead=(2,))
    dy = rng.standard_normal((2, t, n)).astype(np.float32)
    y_j, dx_j, drt_j, dnsq_j = _jax_vjp(side, x, w, basis, rt, 0.95, dy)

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    trt = torch.from_numpy(rt).requires_grad_(True)
    nsq = torch.zeros((), requires_grad=True)
    y = tlayers.lowrank_apply(side, tx, tw, torch.from_numpy(basis), trt,
                              nsq, torch.tensor(0.95))
    y.backward(torch.from_numpy(dy))
    assert _rel(y.detach().numpy(), y_j) <= 1e-5
    assert _rel(tx.grad.numpy(), dx_j) <= 1e-5
    assert _rel(trt.grad.numpy(), drt_j) <= 1e-5
    assert _rel(nsq.grad.numpy(), dnsq_j) <= 1e-5
    assert tw.grad is None                   # no (m, n) gradient exists


def test_norm_probe_is_dense_grad_norm():
    """The probe's gradient is ‖xᵀ∂y‖²_F, the squared norm of the dense
    weight gradient the lift-free path never forms."""
    rng = np.random.default_rng(2)
    x, w, basis, rt = _case(rng, "right", 33, 24, 16, 3)
    dy = rng.standard_normal((33, 16)).astype(np.float32)
    nsq = torch.zeros((), requires_grad=True)
    y = tlayers.lowrank_apply("right", torch.from_numpy(x),
                              torch.from_numpy(w), torch.from_numpy(basis),
                              torch.from_numpy(rt), nsq, torch.tensor(1.0))
    y.backward(torch.from_numpy(dy))
    dense = x.T @ dy
    assert abs(nsq.grad.item() - float(np.sum(dense * dense))) <= \
        1e-5 * float(np.sum(dense * dense))


@pytest.mark.parametrize("side", ["right", "left"])
def test_delta_leaf_through_dense_and_matmul(side):
    """A LowRankDelta leaf reads through ``dense`` and ``x @ leaf``, equal
    to x @ (scale·W + lift(R̃)); its stacked fields slice per layer."""
    rng = np.random.default_rng(3)
    m, n = (12, 8) if side == "right" else (8, 12)
    x, w, basis, rt = _case(rng, side, 5, m, n, 2)
    leaf = tlayers.LowRankDelta(
        w=torch.from_numpy(w)[None].repeat(2, 1, 1),
        basis=torch.from_numpy(basis)[None].repeat(2, 1, 1),
        rt=torch.from_numpy(rt)[None].repeat(2, 1, 1),
        nsq=torch.zeros(2), scale=torch.full((2,), 0.5))
    one = tlayers.LowRankDelta(*(f[1] for f in leaf))
    assert one.side == side
    lifted = 0.5 * w + (rt @ basis.T if side == "right" else basis @ rt)
    xt = torch.from_numpy(x)
    assert np.max(np.abs((xt @ one).numpy() - x @ lifted)) <= 1e-5
    assert np.max(np.abs(tlayers.dense(xt, one).numpy() - x @ lifted)) <= 1e-5
    assert np.max(np.abs(one.read().numpy() - lifted)) <= 1e-6


@pytest.mark.parametrize("side", ["right", "left"])
def test_lowrank_read_grads_match_jax(side):
    rng = np.random.default_rng(4)
    m, n = (10, 6) if side == "right" else (6, 10)
    _, w, basis, rt = _case(rng, side, 1, m, n, 2)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    f = lambda rt_, ns: jlayers.lowrank_read(          # noqa: E731
        side, jnp.asarray(w), jnp.asarray(basis), rt_, ns, jnp.float32(0.9))
    _, vjp = jax.vjp(f, jnp.asarray(rt), jnp.zeros([], jnp.float32))
    drt_j, dnsq_j = vjp(jnp.asarray(dy))
    trt = torch.from_numpy(rt).requires_grad_(True)
    nsq = torch.zeros((), requires_grad=True)
    out = tlayers.lowrank_read(side, torch.from_numpy(w),
                               torch.from_numpy(basis), trt, nsq,
                               torch.tensor(0.9))
    out.backward(torch.from_numpy(dy))
    assert _rel(trt.grad.numpy(), drt_j) <= 1e-5
    assert _rel(nsq.grad.numpy(), dnsq_j) <= 1e-5


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(5)
    x, w, basis, rt = map(torch.from_numpy,
                          _case(rng, "right", 4, 8, 6, 2))
    before = tll.lowrank_linear.launches
    tops.lowrank_linear(x, w, basis, rt, 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        tll.lowrank_linear(x, w, basis, rt, torch.tensor(1.0))
    assert tll.lowrank_linear.launches == before == 0
