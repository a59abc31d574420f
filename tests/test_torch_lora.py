"""Port parity: the LoRA slice — ``repro_torch.core.lora``, the LoRA
baselines' operators of ``core.aggregation`` and the ``optim`` chains they
train with — against the JAX package on seeded inputs.

``lora_init`` / ``tree_lora_init`` draw A with the port's threefry
``normal`` (one ulp from ``jax.random.normal``, ROADMAP Queue 3 i): ≤1e-7
absolute at the 0.02 scale, B zero. ``svd_truncate`` goes through LAPACK
``gesdd`` via SciPy on the CPU, as JAX's does, so its factors match with
signs on a delta with a clear gap at the rank; the other operators ≤1e-5
relative; ``effective_rank`` exactly. The optimizers: one to three steps
of ``sgd`` (with and without momentum, clipped) and ``adam`` on the same
gradients, ≤1e-6 relative.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import aggregation as jagg
from repro.core import lora as jlora
from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.core import aggregation as tagg
from repro_torch.core import lora as tlora
from repro_torch.utils import prng, tree


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _params(rng):
    """A tree with 2-D and stacked 3-D matrix leaves, a vector and a
    non-target matrix, in JAX's (sorted-key) flatten order."""
    return {"emb": rng.standard_normal((12, 8)).astype(np.float32),
            "blocks": {"wq": rng.standard_normal((3, 16, 8)).astype(
                np.float32),
                       "w_up": rng.standard_normal((3, 8, 24)).astype(
                np.float32)},
            "head": rng.standard_normal((8, 5)).astype(np.float32),
            "norm": rng.standard_normal((8,)).astype(np.float32)}


def _target(path, leaf):
    return "emb" not in path


@pytest.mark.parametrize("seed", [0, 17])
def test_tree_lora_init_matches_jax(seed):
    p = _params(np.random.default_rng(seed))
    want = jlora.tree_lora_init(jax.random.PRNGKey(seed),
                                jax.tree_util.tree_map(jnp.asarray, p),
                                _target, 4)
    got = tlora.tree_lora_init(prng.PRNGKey(seed),
                               tree.tree_map(torch.from_numpy, p), _target, 4)
    jl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: x is None or jlora.is_lora_pair(x))[0]
    tl = tree.tree_flatten_with_path(
        got, is_leaf=lambda x: x is None or tlora.is_lora_pair(x))[0]
    assert len(jl) == len(tl) == 5
    for (jpath, j), (tpath, t) in zip(jl, tl):
        assert "/".join(str(getattr(q, "key", q)) for q in jpath) == \
            tree.path_str(tpath)
        assert (j is None) == (t is None)
        if j is None:
            continue
        assert t.a.shape == j.a.shape and t.b.shape == j.b.shape
        assert np.max(np.abs(t.a.numpy() - np.asarray(j.a))) <= 1e-7
        assert not t.b.any() and t.a.dtype == torch.float32


def test_lora_init_rank_capped_and_apply():
    rng = np.random.default_rng(3)
    p = _params(rng)
    ad = tlora.tree_lora_init(prng.PRNGKey(1), tree.tree_map(
        torch.from_numpy, p), _target, 16)
    assert ad["head"].a.shape == (5, 5) and ad["head"].b.shape == (8, 5)
    pair = tlora.lora_init(prng.PRNGKey(2), (3, 16, 8), 4)
    pair = pair._replace(b=torch.from_numpy(
        rng.standard_normal((3, 16, 4)).astype(np.float32)))
    jpair = jlora.LoraPair(a=jnp.asarray(pair.a.numpy()),
                           b=jnp.asarray(pair.b.numpy()))
    got = tlora.apply_lora({"w": torch.from_numpy(p["blocks"]["wq"]),
                            "n": torch.from_numpy(p["norm"])},
                           {"w": pair, "n": None}, 2.0)
    want = jlora.apply_lora({"w": jnp.asarray(p["blocks"]["wq"]),
                             "n": jnp.asarray(p["norm"])},
                            {"w": jpair, "n": None}, 2.0)
    assert _rel(got["w"].numpy(), want["w"]) <= 1e-6
    assert torch.equal(got["n"], torch.from_numpy(p["norm"]))
    assert _rel(tlora.lora_delta(pair, 2.0).numpy(),
                jlora.lora_delta(jpair, 2.0)) <= 1e-6
    with pytest.raises(ValueError, match="float32"):
        tlora.lora_init(prng.PRNGKey(0), (4, 4), 2, dtype=torch.bfloat16)


def _gapped(rng, lead, m, n, r):
    """A delta with singular values 2..1 down to rank r, then 1e-2..1e-3."""
    u = np.linalg.qr(rng.standard_normal(lead + (m, m)))[0]
    v = np.linalg.qr(rng.standard_normal(lead + (n, n)))[0]
    k = min(m, n)
    s = np.concatenate([np.linspace(2.0, 1.0, r),
                        np.linspace(1e-2, 1e-3, k - r)])
    return ((u[..., :, :k] * s) @ np.swapaxes(v[..., :, :k], -1, -2)
            ).astype(np.float32)


@pytest.mark.parametrize("lead,m,n", [((), 24, 16), ((3,), 16, 24),
                                      ((2,), 20, 20)])
def test_svd_truncate_and_rank_diagnostics(lead, m, n):
    d = _gapped(np.random.default_rng(5), lead, m, n, 4)
    jp = jlora.svd_truncate(jnp.asarray(d), 4)
    tp = tlora.svd_truncate(torch.from_numpy(d), 4)
    assert tp.a.shape == jp.a.shape and tp.b.shape == jp.b.shape
    assert _rel(tp.a.numpy(), jp.a) <= 1e-5
    assert _rel(tp.b.numpy(), jp.b) <= 1e-5
    for r in (1, 4, 6):
        assert _rel(tlora.rank_tail_energy(torch.from_numpy(d), r).numpy(),
                    jlora.rank_tail_energy(jnp.asarray(d), r)) <= 1e-5
    for tol in (1e-6, 1e-2, 0.7):
        assert np.array_equal(
            tlora.effective_rank(torch.from_numpy(d), tol).numpy(),
            np.asarray(jlora.effective_rank(jnp.asarray(d), tol)))
    got = tagg.truncate_to_rank({"d": torch.from_numpy(d), "x": None}, 4)
    want = jagg.truncate_to_rank({"d": jnp.asarray(d), "x": None}, 4)
    assert got["x"] is None and _rel(got["d"].numpy(), want["d"]) <= 1e-5


def _stacked_adapters(rng, k, lead, m, n, r):
    a = (0.3 * rng.standard_normal((k,) + lead + (r, n))
         + rng.standard_normal(lead + (r, n))).astype(np.float32)
    b = rng.standard_normal((k,) + lead + (m, r)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("lead", [(), (3,)])
def test_factor_aggregations_match_jax(lead):
    rng = np.random.default_rng(11)
    a1, b1 = _stacked_adapters(rng, 4, lead, 16, 12, 4)
    a2, b2 = _stacked_adapters(rng, 4, lead, 10, 20, 3)
    w = np.linspace(1.0, 2.0, 4).astype(np.float32)
    jt = {"p": jlora.LoraPair(a=jnp.asarray(a1), b=jnp.asarray(b1)),
          "q": jlora.LoraPair(a=jnp.asarray(a2), b=jnp.asarray(b2)),
          "z": None}
    tt = {"p": tlora.LoraPair(a=torch.from_numpy(a1), b=torch.from_numpy(b1)),
          "q": tlora.LoraPair(a=torch.from_numpy(a2), b=torch.from_numpy(b2)),
          "z": None}
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for name, args in (("factor_average", ()), ("lift_average", (2.0,)),
                       ("lora_fair_refine", (2.0,))):
        want = getattr(jagg, name)(jt, jw, *args)
        got = getattr(tagg, name)(tt, tw, *args)
        assert got["z"] is None
        jl = jax.tree_util.tree_leaves(want)
        tl = tree.tree_leaves(got)
        assert len(jl) == len(tl) > 0
        for g, x in zip(tl, jl):
            assert tuple(g.shape) == x.shape
            assert _rel(g.numpy(), x) <= 1e-5, name
    base = {"p": rng.standard_normal(lead + (16, 12)).astype(np.float32),
            "q": rng.standard_normal(lead + (10, 20)).astype(np.float32),
            "z": rng.standard_normal((7,)).astype(np.float32)}
    want = jagg.fr_lora_merge(jax.tree_util.tree_map(jnp.asarray, base), jt,
                              jw, 2.0)
    got = tagg.fr_lora_merge(tree.tree_map(torch.from_numpy, base), tt, tw,
                             2.0)
    for key in base:
        assert _rel(got[key].numpy(), want[key]) <= 1e-5


def _grads(rng, shapes, steps):
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(steps)]


@pytest.mark.parametrize("name,kw", [("sgd", {}),
                                     ("sgd", dict(momentum=0.9)),
                                     ("sgd", dict(momentum=0.9,
                                                  clip_norm=1.0)),
                                     ("adam", {}),
                                     ("adam", dict(clip_norm=0.5))])
def test_optimizer_steps_match_jax(name, kw):
    rng = np.random.default_rng(2)
    shapes = {"a": (4, 6), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jtx = getattr(joptim, name)(1e-2, **kw)
    ttx = getattr(toptim, name)(1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in _grads(rng, shapes, 3):
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(tree.tree_map(torch.from_numpy, g), ts, tp)
        jp = joptim.apply_updates(jp, ju)
        tp = toptim.apply_updates(tp, tu)
        for k in shapes:
            assert _rel(tu[k].numpy(), ju[k]) <= 1e-6
            assert _rel(tp[k].numpy(), jp[k]) <= 1e-6
    if kw.get("momentum"):
        mom = next(s for s in ts if isinstance(s, toptim.MomentumState))
        jmom = next(s for s in js if isinstance(s, joptim.MomentumState))
        assert _rel(mom.momentum["a"].numpy(), jmom.momentum["a"]) <= 1e-6


def test_apply_updates_casts_and_skips_none():
    p = {"w": torch.ones(3, dtype=torch.bfloat16), "x": None}
    u = {"w": torch.full((3,), 1e-3), "x": None}
    out = toptim.apply_updates(p, u)
    assert out["x"] is None and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], p["w"] + u["w"].to(torch.bfloat16))


def test_bf16_merge_matches_jax():
    """``merge_lora`` on bf16 base weights: W0 + (s·B·A) cast to bf16. A
    one-ulp fp32 difference in B·A could flip a bf16 rounding; on the same
    adapters the two packages' merges agree entry for entry within one
    bf16 ulp, on at most 1e-3 of the entries (measured: none differ)."""
    from repro.core import fed as jfed
    from repro_torch.core import fed as tfed
    rng = np.random.default_rng(12)
    base = rng.standard_normal((2, 256, 192)).astype(np.float32) * 0.02
    a = (0.02 * rng.standard_normal((2, 4, 192))).astype(np.float32)
    b = (0.05 * rng.standard_normal((2, 256, 4))).astype(np.float32)
    want = np.asarray(jfed.merge_lora(
        {"w": jnp.asarray(base, jnp.bfloat16)},
        {"w": jlora.LoraPair(a=jnp.asarray(a), b=jnp.asarray(b))},
        2.0)["w"], np.float32)
    got = tfed.merge_lora(
        {"w": torch.from_numpy(base).to(torch.bfloat16)},
        {"w": tlora.LoraPair(a=torch.from_numpy(a), b=torch.from_numpy(b))},
        2.0)["w"]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) <= 1e-3
