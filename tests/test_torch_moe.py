"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe`` on
the same numpy inputs, on the CPU.

Routing (``route``) picks the same experts and holds its gates and aux
loss to 1e-6, with ties (a zero router: every probability equal, the
lowest expert indices win as ``lax.top_k`` orders them); ``capacity`` is
equal; dispatch and combine with capacity drops keep the same sorted
order, slots and tokens, and the combined output is within 1e-6 of its
scale;
``moe_forward`` with shared experts is within 1e-6 in fp32 and within
one bf16 ulp of the output's scale in bf16.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

TOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(rng, d, e, f, shared, dtype=np.float32):
    p = {"router": _rand(rng, d, e, scale=0.5),
         "w_gate": _rand(rng, e, d, f, scale=0.2),
         "w_up": _rand(rng, e, d, f, scale=0.2),
         "w_down": _rand(rng, e, f, d, scale=0.2)}
    if shared:
        p["shared"] = {"w_gate": _rand(rng, d, f, scale=0.2),
                       "w_up": _rand(rng, d, f, scale=0.2),
                       "w_down": _rand(rng, f, d, scale=0.2)}
    return p


def _both(p, jdtype, tdtype):
    """The same params for both packages; the router stays fp32."""
    def j(path, x):
        return jnp.asarray(x, jnp.float32 if path == "router" else jdtype)

    def t(path, x):
        return torch.from_numpy(x).to(torch.float32 if path == "router"
                                      else tdtype)

    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, v)
                for k, v in tree.items()}
    return walk(p, j), walk(p, t)


@pytest.mark.parametrize("n,e,k", [(12, 4, 2), (40, 8, 3), (7, 32, 8)])
def test_route_matches_jax(n, e, k):
    rng = np.random.default_rng(n)
    x, w = _rand(rng, n, 16), _rand(rng, 16, e)
    jg, ji, ja = jmoe.route(jnp.asarray(w), jnp.asarray(x), k)
    tg, ti, ta = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.max(np.abs(_np(tg) - _np(jg))) <= TOL
    assert abs(float(ta) - float(ja)) <= TOL * max(1.0, abs(float(ja)))


def test_route_ties_take_lowest_index():
    """A zero router gives every expert probability 1/E: both packages
    pick experts 0..k-1 in order, with equal gates 1/k."""
    x = _rand(np.random.default_rng(0), 5, 16)
    w = np.zeros((16, 8), np.float32)
    jg, ji, ja = jmoe.route(jnp.asarray(w), jnp.asarray(x), 3)
    tg, ti, ta = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), 3)
    assert np.array_equal(np.asarray(ji), np.tile(np.arange(3), (5, 1)))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.max(np.abs(_np(tg) - _np(jg))) <= TOL
    assert abs(float(ta) - float(ja)) <= TOL


@pytest.mark.parametrize("n,e,k,cf", [(1, 32, 8, 1.25), (8, 32, 8, 1.25),
                                      (128, 32, 8, 1.25), (24, 4, 2, 1.0),
                                      (1000, 64, 6, 0.5), (3, 4, 2, 8.0)])
def test_capacity_matches_jax(n, e, k, cf):
    assert tmoe.capacity(n, e, k, cf) == jmoe.capacity(n, e, k, cf)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_dispatch_and_combine_with_drops(cf):
    """Skewed routing (two experts favoured) under a tight capacity drops
    tokens: the sorted order, the slot → token map, the slots' sorted
    positions and the valid mask are equal, and the combined output is
    within 1e-6 of its scale."""
    rng = np.random.default_rng(3)
    n, e, k, d = 32, 4, 2, 8
    x = _rand(rng, n, d)
    x[:, 0] = np.abs(x[:, 0]) + 1.0
    w = _rand(rng, d, e, scale=0.1)
    w[0, :2] += 3.0                         # experts 0, 1 oversubscribed
    jg, ji, _ = jmoe.route(jnp.asarray(w), jnp.asarray(x), k)
    tg, ti, _ = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), k)
    cap = jmoe.capacity(n, e, k, cf)
    jbuf, jbook = jmoe.dispatch_gather(jnp.asarray(x), ji, cap, e)
    tbuf, tbook = tmoe.dispatch_gather(torch.from_numpy(x), ti, cap, e)
    valid = np.asarray(jbook[3])
    assert valid.sum() < n * k              # some assignments dropped
    for got, want in zip(tbook, jbook):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(_np(tbuf), _np(jbuf))
    out_e = _rand(rng, e, cap, d)
    jout = jmoe.combine_scatter(jnp.asarray(out_e), jbook, jg, n)
    tout = tmoe.combine_scatter(torch.from_numpy(out_e), tbook, tg, n)
    scale = np.max(np.abs(_np(jout)))
    assert np.max(np.abs(_np(tout) - _np(jout))) <= TOL * max(1.0, scale)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_forward_fp32(shared, act):
    rng = np.random.default_rng(5)
    p = _params(rng, 16, 4, 24, shared)
    x = _rand(rng, 3, 7, 16)
    jp, tp = _both(p, jnp.float32, torch.float32)
    jo, ja = jmoe.moe_forward(jp, jnp.asarray(x), k=2, act=act,
                              capacity_factor=1.0)
    to, ta = tmoe.moe_forward(tp, torch.from_numpy(x), k=2, act=act,
                              capacity_factor=1.0)
    scale = np.max(np.abs(_np(jo)))
    assert np.max(np.abs(_np(to) - _np(jo))) <= TOL * max(1.0, scale)
    assert abs(float(ta) - float(ja)) <= TOL * max(1.0, abs(float(ja)))


def test_moe_forward_bf16_within_one_ulp():
    """bf16 params and activations, granite-like routing (8 of 32, one
    shared expert): within one bf16 ulp of the output's scale."""
    rng = np.random.default_rng(6)
    p = _params(rng, 64, 32, 32, shared=True)
    x = _rand(rng, 2, 16, 64)
    jp, tp = _both(p, jnp.bfloat16, torch.bfloat16)
    jo, _ = jmoe.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), k=8)
    to, _ = tmoe.moe_forward(tp, torch.from_numpy(x).bfloat16(), k=8)
    assert to.dtype == torch.bfloat16
    want = _np(jo)
    ulp = np.exp2(np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.max(np.abs(_np(to) - want)) <= ulp


def test_moe_forward_gradients_match_jax():
    """The gradient of a loss through the MoE reaches x, the router and
    the experts as JAX's does (1e-5 of each gradient's scale)."""
    rng = np.random.default_rng(7)
    p = _params(rng, 16, 4, 24, shared=True)
    x = _rand(rng, 2, 5, 16)
    jp, _ = _both(p, jnp.float32, torch.float32)

    def jloss(pp, xx):
        out, aux = jmoe.moe_forward(pp, xx, k=2, capacity_factor=1.0)
        return jnp.sum(out * out) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree_util.tree_map(
        lambda v: torch.from_numpy(np.array(v)).requires_grad_(True), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_forward(tp, tx, k=2, capacity_factor=1.0)
    (torch.sum(out * out) + aux).backward()
    pairs = [(tx.grad, jgx)] + [
        (tp[a][b].grad if b else tp[a].grad, jgp[a][b] if b else jgp[a])
        for a, b in (("router", None), ("w_gate", None), ("w_up", None),
                     ("w_down", None), ("shared", "w_up"))]
    for got, want in pairs:
        want = _np(want)
        assert np.max(np.abs(_np(got) - want)) <= \
            1e-5 * max(np.max(np.abs(want)), 1e-30)


def test_params_from_jax_keeps_routers_fp32():
    """A cast on carry-across leaves MoE routers fp32, as both packages
    keep them; the experts take the cast."""
    from repro_torch.models.convert import params_from_jax
    rng = np.random.default_rng(8)
    p = {"blocks": [{"moe": _params(rng, 8, 4, 6, shared=True)}]}
    out = params_from_jax(p, "cpu", dtype=torch.bfloat16)["blocks"][0]["moe"]
    assert out["router"].dtype == torch.float32
    assert np.array_equal(out["router"].numpy(), p["blocks"][0]["moe"]["router"])
    assert out["w_gate"].dtype == out["shared"]["w_up"].dtype == \
        torch.bfloat16
