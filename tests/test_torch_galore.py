"""Port parity: ``repro_torch.core.galore`` and the fused GaLore kernels'
plain versions against the JAX package, from the same carried-across
optimizer state (``models.convert.opt_state_from_jax``).

* ``galore_init`` bases equal JAX's leaf for leaf (≤1e-6: seeded threefry
  draws and a sign-fixed QR).
* ``galore_precond_ref`` / ``galore_adamw_ref`` against the Pallas kernels
  in interpret mode: both sides, stacked 3-D blocks, odd M, both
  ``project_back`` values, ≤1e-5 relative.
* ``galore_transform_update`` (dense and ``projected=True``),
  ``manual_refresh`` and ``factored_adamw_step`` with clipping, ≤1e-5.
* The carry-across round-trips the state exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core import galore as jgal
from repro.core.fed import split_trainable as jsplit
from repro.kernels import galore_adamw as jkern
from repro.launch.steps import galore_target_fn as jtarget
from repro.models import model as jmodel
from repro_torch.core import galore as tgal
from repro_torch.kernels import galore_adamw as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.convert import (opt_state_from_jax,
                                        opt_state_to_numpy, params_from_jax)
from repro_torch.utils import tree

RANK = 4
LR = 3e-3


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _jblocks(state):
    return jax.tree_util.tree_leaves(state.blocks, is_leaf=lambda x: isinstance(
        x, (jgal.GaloreBlockState, jgal.DenseMoments)))


def _tblocks(state):
    return tree.tree_leaves(state.blocks, is_leaf=tgal._is_block)


@pytest.fixture(scope="module")
def setup():
    """JAX smoke-qwen trainables, a JAX GaLore optimizer state with random
    moments at count 2 (as after two steps), the gradients of a third
    step, and the port's copies of all of it."""
    cfg = jsmoke(jget_config("qwen1.5-0.5b"))
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    jtr, _ = jsplit(params, jtarget(cfg))
    gcfg = jgal.GaloreConfig(rank=RANK, refresh_every=10 ** 9)
    tx = jgal.galore_adamw(gcfg, LR, 0.01, seed=0, clip_norm=1.0)
    rng = np.random.default_rng(0)
    st = tx.init(jtr)
    g = jgal.galore_state_of(st)
    blocks = jax.tree_util.tree_map(
        lambda b: jgal.GaloreBlockState(
            basis=b.basis,
            m=jnp.asarray(0.01 * rng.standard_normal(b.m.shape), jnp.float32),
            v=jnp.asarray(1e-4 * rng.random(b.v.shape), jnp.float32)),
        g.blocks, is_leaf=lambda x: isinstance(x, jgal.GaloreBlockState))
    st = jgal.replace_galore_state(
        st, g._replace(count=jnp.asarray(2, jnp.int32), blocks=blocks))
    st = st[:-1] + (st[-1]._replace(count=jnp.asarray(2, jnp.int32)),)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(0.05 * rng.standard_normal(p.shape),
                              jnp.float32), jtr)
    ttr = params_from_jax(_np_tree(jtr), "cpu")
    return dict(jtr=jtr, ttr=ttr, gcfg=gcfg,
                tcfg=tgal.GaloreConfig(rank=RANK, refresh_every=10 ** 9),
                jst=st, tst=opt_state_from_jax(_np_tree(st), "cpu"),
                jg=grads, tg=params_from_jax(_np_tree(grads), "cpu"))


def test_galore_init_bases_equal(setup):
    js = jgal.galore_init(setup["gcfg"], setup["jtr"], seed=3)
    ts = tgal.galore_init(setup["tcfg"], setup["ttr"], seed=3)
    jb, tb = _jblocks(js), _tblocks(ts)
    assert len(jb) == len(tb) == 7
    for a, b in zip(jb, tb):
        assert np.max(np.abs(np.asarray(a.basis) - b.basis.numpy())) <= 1e-6
        assert tuple(a.m.shape) == tuple(b.m.shape)


def test_state_round_trip(setup):
    back = opt_state_to_numpy(setup["tst"])
    want = _np_tree(setup["jst"])
    gb, gw = tgal.galore_state_of(back), jgal.galore_state_of(want)
    assert gb.count == int(gw.count) == 2 and gb.seed == int(gw.seed)
    for a, b in zip(jax.tree_util.tree_leaves(gw.blocks), tree.tree_leaves(
            gb.blocks)):
        assert np.array_equal(a, b)
    assert [type(s).__name__ for s in back] == [type(s).__name__
                                               for s in want]


@pytest.mark.parametrize("side,m,n", [("right", 37, 24), ("left", 24, 41)])
@pytest.mark.parametrize("project_back", [True, False])
def test_precond_ref_matches_pallas(side, m, n, project_back):
    rng = np.random.default_rng(1)
    r, lead = 4, (3,)
    dim = n if side == "right" else m
    g = rng.standard_normal(lead + (m, n)).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal(lead + (dim, r)))[0].astype(
        np.float32)
    msh = lead + ((m, r) if side == "right" else (r, n))
    mom = (0.1 * rng.standard_normal(msh)).astype(np.float32)
    vel = (0.01 * rng.random(msh)).astype(np.float32)
    want = jkern.galore_precond_step(
        *map(jnp.asarray, (g, basis, mom, vel)), 5.0, side=side,
        block_rows=16, interpret=True, project_back=project_back)
    c1, c2 = tkern.bias_corrections(5, 0.9, 0.999)
    got = tref.galore_precond_ref(*map(torch.from_numpy, (g, basis, mom, vel)),
                                  c1=c1, c2=c2, side=side,
                                  project_back=project_back)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(b.numpy(), a) <= 1e-5
    via_ops = tops.galore_precond_step(
        *map(torch.from_numpy, (g, basis, mom, vel)), 5,
        project_back=project_back)
    for a, b in zip(got, via_ops):
        assert torch.equal(a, b)
    assert tkern.galore_precond_step.launches == 0


@pytest.mark.parametrize("side,m,n", [("right", 37, 24), ("left", 24, 41)])
def test_adamw_ref_matches_pallas(side, m, n):
    rng = np.random.default_rng(2)
    r = 4
    dim = n if side == "right" else m
    w = rng.standard_normal((2, m, n)).astype(np.float32)
    g = rng.standard_normal((2, m, n)).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal((2, dim, r)))[0].astype(
        np.float32)
    msh = (2,) + ((m, r) if side == "right" else (r, n))
    mom = (0.1 * rng.standard_normal(msh)).astype(np.float32)
    vel = (0.01 * rng.random(msh)).astype(np.float32)
    want = jkern.galore_adamw_step(*map(jnp.asarray, (w, g, basis, mom, vel)),
                                   3.0, side=side, lr=1e-2,
                                   weight_decay=0.1, block_rows=8,
                                   interpret=True)
    c1, c2 = tkern.bias_corrections(3, 0.9, 0.999)
    got = tref.galore_adamw_ref(*map(torch.from_numpy, (w, g, basis, mom,
                                                        vel)),
                                c1=c1, c2=c2, side=side, lr=1e-2,
                                weight_decay=0.1)
    for a, b in zip(want, got):
        assert _rel(b.numpy(), a) <= 1e-5
    via_ops = tops.galore_adamw_step(
        *map(torch.from_numpy, (w, g, basis, mom, vel)), 3, lr=1e-2,
        weight_decay=0.1)
    for a, b in zip(got, via_ops):
        assert torch.equal(a, b)
    assert tkern.galore_adamw_step.launches == 0


def _compare_states(jstate, tstate, tol=1e-5):
    for a, b in zip(_jblocks(jgal.galore_state_of(jstate)),
                    _tblocks(tgal.galore_state_of(tstate))):
        for fa, fb in zip(a, b):
            assert _rel(fb.numpy(), fa) <= tol


@pytest.mark.parametrize("projected", [False, True])
def test_transform_update_matches(setup, projected):
    jg, tg = setup["jg"], setup["tg"]
    jst = jgal.galore_state_of(setup["jst"])
    tst = tgal.galore_state_of(setup["tst"])
    if projected:      # feed both the projected gradients of the dense ones
        jg = jax.tree_util.tree_map(
            lambda g, b: jnp.asarray(_proj(np.asarray(g), np.asarray(b))),
            jg, jgal.extract_bases(jst))
        tg = params_from_jax(_np_tree(jg), "cpu")
    ju, jn = jgal.galore_transform_update(setup["gcfg"], jg, jst,
                                          project_back=True,
                                          projected=projected)
    tu, tn = tgal.galore_transform_update(setup["tcfg"], tg, tst,
                                          project_back=True,
                                          projected=projected)
    assert tn.count == int(jn.count) == 3
    for a, b in zip(jax.tree_util.tree_leaves(ju), tree.tree_leaves(tu)):
        assert _rel(b.numpy(), a) <= 1e-5
    _compare_states(jn, tn)


def _proj(g, b):
    m, n = g.shape[-2:]
    return g @ b if m >= n else np.swapaxes(b, -1, -2) @ g


def test_manual_refresh_matches(setup):
    jst = jgal.galore_state_of(setup["jst"])
    tst = tgal.galore_state_of(setup["tst"])
    jn = jgal.manual_refresh(setup["gcfg"], jgal.with_seed(jst, 7), 3)
    tn = tgal.manual_refresh(setup["tcfg"], tgal.with_seed(tst, 7), 3)
    _compare_states(jn, tn)
    assert tgal.maybe_refresh_instep(setup["tcfg"], tst) is tst   # count 2


@pytest.mark.parametrize("lift_free", [False, True])
def test_factored_adamw_step_matches(setup, lift_free):
    jst, tst = setup["jst"], setup["tst"]
    jd = jax.tree_util.tree_map(lambda m: 0.01 * jnp.ones_like(m),
                                jgal.zero_client_deltas(
                                    jgal.galore_state_of(jst)))
    td = params_from_jax(_np_tree(jd), "cpu")
    jg, tg = setup["jg"], setup["tg"]
    if lift_free:
        bases = jgal.extract_bases(jgal.galore_state_of(jst))
        jproj = jax.tree_util.tree_map(
            lambda g, b: jnp.asarray(_proj(np.asarray(g), np.asarray(b))),
            jg, bases)
        jnsq = jax.tree_util.tree_map(
            lambda g: jnp.sum(g * g, axis=(-2, -1)), jg)
        jg = jgal.LiftFreeGrads(proj=jproj, nsq=jnsq)
        tg = tgal.LiftFreeGrads(proj=params_from_jax(_np_tree(jproj), "cpu"),
                                nsq=params_from_jax(_np_tree(jnsq), "cpu"))
    jd2, js2, jst2 = jgal.factored_adamw_step(
        setup["gcfg"], jg, jst, jd, jnp.float32(0.99), lr=LR,
        weight_decay=0.01, clip_norm=0.5)
    td2, ts2, tst2 = tgal.factored_adamw_step(
        setup["tcfg"], tg, tst, td, torch.tensor(0.99), lr=LR,
        weight_decay=0.01, clip_norm=0.5)
    assert abs(float(ts2) - float(js2)) <= 1e-7
    for a, b in zip(jax.tree_util.tree_leaves(jd2), tree.tree_leaves(td2)):
        assert _rel(b.numpy(), a) <= 1e-5
    _compare_states(jst2, tst2)
    assert tst2[-1].count == int(jst2[-1].count)


def test_layout_helpers(setup):
    tst = setup["tst"]
    g = tgal.galore_state_of(tst)
    stacked = tgal.stack_opt_states([tst, tst, tst])
    sg = tgal.galore_state_of(stacked)
    assert sg.count == g.count and sg.seed == g.seed
    for a, b in zip(_tblocks(g), _tblocks(sg)):
        assert b.basis.shape == (3,) + a.basis.shape
        assert torch.equal(b.v[1], a.v)
    v = tgal.extract_projected_v(g)
    back = tgal.with_projected_v(g, tree.tree_map(lambda x: -x, v))
    assert all(torch.all(b.v == 0) for b in _tblocks(back))
    assert tgal.with_seed(g, 2 ** 32 + 5).seed == 5


# ------------------------------------------------ the CUDA kernel's plan --

PLAN_SHAPES = [((4, 24), 1024, 1024), ((2, 24), 1024, 2816),
               ((1, 24), 2816, 1024), ((3,), 37, 20), ((2,), 20, 37),
               ((1, 2), 1024, 2816), ((1,), 1, 64), ((1,), 64, 1)]


def _side(mm, nn):
    return tkern.RIGHT if mm >= nn else tkern.LEFT


@pytest.mark.parametrize("lead,mm,nn", PLAN_SHAPES)
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [8, 16, 64])
def test_plan_covers_every_element_once(lead, mm, nn, g_dtype, r):
    """Each row and each column of a batch item is visited once by the
    kernel's loops (a right warp's row groups and lane's chunks, a left
    block's columns and warp's rows), in every mode; the shared memory
    fits a block, the basis staged in it only where it fits."""
    side = _side(mm, nn)
    if r > min(mm, nn):
        r = min(mm, nn)
    batch = int(np.prod(lead))
    for mode in (tkern.PRECOND_UT, tkern.PRECOND_U, tkern.ADAMW):
        p = tkern.plan(side, mm, nn, r, g_dtype, mode, batch=batch)
        staged = 16 * -(-r // 4) * (-(-nn // 8) * 8 if side == tkern.RIGHT
                                    else mm)
        assert p.smem <= tkern.SMEM_LIMIT
        if p.basis == "shared":
            assert p.smem >= staged
        else:
            assert p.basis == "global" and p.smem + staged > tkern.SMEM_LIMIT
        assert p.grid[1] == batch and p.grid[0] >= 1
        rows, cols = tkern.coverage(p, mm, nn)
        assert torch.all(rows == 1) and torch.all(cols == 1)


def test_plan_path_buckets():
    """Round 0's buckets: fp32 g (as the clip leaves it) loads into
    registers, bf16 g streams through the ring; rank 8 holds 8 rows a warp
    or 8 columns a lane; the right grid fills the card's resident blocks
    with at least 64 rows a block."""
    for (lead, mm, nn), route in zip(PLAN_SHAPES[:3],
                                     ("right", "left", "right")):
        for g_dtype, suffix in ((torch.float32, ""),
                                (torch.bfloat16, "_ring")):
            p = tkern.plan(_side(mm, nn), mm, nn, 8, g_dtype,
                           tkern.PRECOND_UT, batch=int(np.prod(lead)))
            assert p.route == route + suffix and p.vec
            assert (p.rmax, p.hold) == (8, 8)
            if route == "right":
                per_sm = min(tkern.RIGHT_BLOCKS_PER_SM,
                             tkern.SMEM_PER_SM // (p.smem + 1024))
                assert p.grid[0] * p.grid[1] <= tkern.H100_SMS * per_sm
                assert p.tile >= tkern.MIN_TILE_ROWS
            else:
                assert p.tile == 256 and p.grid[0] == -(-nn // 256)


# jamba-1.5-large-398b's round-0 buckets at rank 8: every basis of 8192
# rows takes 256 KB, over a block's shared memory; (8192, 1024) stages.
WIDE_BUCKETS = [((2, 1), 8192, 1024, "shared"),
                ((2, 1), 8192, 8192, "global"),
                ((4, 1), 8192, 24576, "global"),
                ((3, 1), 8192, 32768, "global"),
                ((2, 1), 24576, 8192, "global"),
                ((3, 1), 16384, 8192, "global")]


@pytest.mark.parametrize("lead,mm,nn,where", WIDE_BUCKETS)
def test_plan_reads_a_wide_basis_from_global_memory(lead, mm, nn, where):
    """A basis whose staged copy exceeds a block's shared memory is read
    from global memory: the same routes, loops and coverage, no staged
    bytes in the shared memory."""
    side = _side(mm, nn)
    for g_dtype in (torch.float32, torch.bfloat16):
        p = tkern.plan(side, mm, nn, 8, g_dtype, tkern.PRECOND_UT,
                       batch=int(np.prod(lead)))
        assert p.basis == where and p.smem <= tkern.SMEM_LIMIT
        assert p.route == side + ("_ring" if g_dtype == torch.bfloat16
                                  else "")
        rows, cols = tkern.coverage(p, mm, nn)
        assert torch.all(rows == 1) and torch.all(cols == 1)


@pytest.mark.parametrize("side", [tkern.RIGHT, tkern.LEFT])
def test_plan_vector_loads_only_on_aligned_rows(side):
    """Pieces of up to 16 bytes only where every row of g (and of u in mode
    1, of w in mode 2) starts on a piece boundary, and never for an
    unaligned pointer."""
    for n in range(1, 41):
        for g_dtype in (torch.float32, torch.bfloat16):
            for mode, w_dtype in ((tkern.PRECOND_UT, torch.float32),
                                  (tkern.PRECOND_U, torch.float32),
                                  (tkern.ADAMW, torch.bfloat16)):
                p = tkern.plan(side, 48, n, 8, g_dtype, mode,
                               w_dtype=w_dtype)
                sizes = [g_dtype.itemsize] + \
                    ([4] if mode == tkern.PRECOND_U else []) + \
                    ([2] if mode == tkern.ADAMW else [])
                want = all(n % (16 // s) == 0 for s in sizes)
                assert p.vec == want, (n, g_dtype, mode)
                assert p.route.endswith("_scalar") == (not want)
                assert not tkern.plan(side, 48, n, 8, g_dtype, mode,
                                      w_dtype=w_dtype, aligned=False).vec


def test_plan_route_follows_rank_and_dtype():
    """The rank instantiation and what a lane holds follow r; the ring
    follows g's type (and, on the left, whole 16-byte pieces a lane)."""
    for r, rmax in ((1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (33, 64),
                    (64, 64)):
        for side, mm, nn in ((tkern.RIGHT, 256, 128),
                             (tkern.LEFT, 128, 256)):
            p32 = tkern.plan(side, mm, nn, r, torch.float32,
                             tkern.PRECOND_UT)
            p16 = tkern.plan(side, mm, nn, r, torch.bfloat16,
                             tkern.PRECOND_UT)
            assert p32.rmax == p16.rmax == rmax
            assert p32.hold == p16.hold == 64 // rmax
            assert p32.route == side
            ring = side == tkern.RIGHT or rmax == 8
            assert p16.route == side + ("_ring" if ring else "")
    with pytest.raises(ValueError):
        tkern.rank_instance(65)
    with pytest.raises(TypeError):
        tkern.plan(tkern.RIGHT, 64, 64, 8, torch.float16, tkern.PRECOND_UT)
    # a (1024, 64) basis is 256 KB: read from global memory, not staged
    p = tkern.plan(tkern.RIGHT, 2048, 1024, 64, torch.float32,
                   tkern.PRECOND_U)
    assert p.basis == "global" and p.smem <= tkern.SMEM_LIMIT - 65536


@pytest.mark.parametrize("side,m,n", [("right", 37, 20), ("left", 20, 44)])
def test_bf16_g_equals_its_fp32_copy(side, m, n):
    """On the CPU the ops entry points take the plain versions, which
    compute in fp32: a bf16 g gives what its fp32 copy gives, bit for bit
    (the kernel is gated the same way on the card)."""
    rng = np.random.default_rng(3)
    r, dim = 4, (n if side == "right" else m)
    g = torch.from_numpy(rng.standard_normal((2, m, n)).astype(np.float32))
    g = g.to(torch.bfloat16)
    basis = torch.from_numpy(np.linalg.qr(rng.standard_normal(
        (2, dim, r)))[0].astype(np.float32))
    msh = (2,) + ((m, r) if side == "right" else (r, n))
    mom = torch.from_numpy((0.1 * rng.standard_normal(msh)).astype(
        np.float32))
    vel = torch.from_numpy((0.01 * rng.random(msh)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, m, n)).astype(np.float32))
    for pb in (True, False):
        a = tops.galore_precond_step(g, basis, mom, vel, 4, project_back=pb)
        b = tops.galore_precond_step(g.float(), basis, mom, vel, 4,
                                     project_back=pb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = tops.galore_adamw_step(w, g, basis, mom, vel, 4, lr=1e-2)
    b = tops.galore_adamw_step(w, g.float(), basis, mom, vel, 4, lr=1e-2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tkern.galore_precond_step.launches == 0
    assert sum(tkern.galore_precond_step.routes.values()) == 0


def test_transform_update_bf16_grads_matches(setup):
    """bf16 gradients through the bucketed update (stacked in bf16, read by
    the kernel as they are) against JAX's, which casts them to fp32 before
    its kernel: JAX is fed that exact fp32 copy, the shapes and types of
    test_transform_update_matches, whose compiled program it reuses."""
    tg = tree.tree_map(lambda g: g.to(torch.bfloat16), setup["tg"])
    jg = jax.tree_util.tree_map(
        lambda g: jnp.asarray(g.float().numpy()), tg)
    jst = jgal.galore_state_of(setup["jst"])
    tst = tgal.galore_state_of(setup["tst"])
    ju, jn = jgal.galore_transform_update(setup["gcfg"], jg, jst,
                                          project_back=True)
    tu, tn = tgal.galore_transform_update(setup["tcfg"], tg, tst,
                                          project_back=True)
    assert all(x.dtype == torch.bfloat16 for x in tree.tree_leaves(tg))
    for a, b in zip(jax.tree_util.tree_leaves(ju), tree.tree_leaves(tu)):
        assert _rel(b.numpy(), a) <= 1e-5
    _compare_states(jn, tn)
