"""Port parity for RWKV6 training: the WKV backward, its kernel's pure plan
and dispatch, the RWKV branches of ``forward`` / ``loss_fn`` and the
training CLI, JAX package vs ``repro_torch`` on the CPU.

The same numpy inputs, made from a seed, go through both packages.

Tolerances:
- ``ref.rwkv6_scan_bwd_ref`` against torch autograd through
  ``ref.rwkv6_scan_ref``: ≤ 1e-6 of each cotangent's scale in fp32 (the
  two sum in other orders; measured ≤ 4.6e-7);
- the same against ``jax.vjp`` of JAX's ``ref.rwkv6_scan_ref``: ≤ 1e-5 in
  fp32 (the forwards already part by 1.7e-7–3.0e-7, ROADMAP Queue 3 k),
  and one bf16 ulp of the scale for bf16 r, k, v (the fp32 cotangent is
  rounded once, and a last-place difference can cross a rounding
  boundary);
- the gradients of ``time_mix_forward``, ``channel_mix_forward`` and the
  rwkv6-1.6b smoke ``loss_fn`` against ``jax.grad``: ≤ 1e-5 of each
  gradient's scale (measured ≤ 1.7e-6 for ``loss_fn``).
The FedEngine rounds are ``test_torch_rwkv_fed.py``'s, except FedIT's
and FedAvg-Full's, which are here.
"""
import importlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch
from threadpoolctl import threadpool_limits

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.fed import FedConfig as JFedConfig
from repro.core.fed import FedEngine as JFedEngine
from repro.data import FederatedBatcher as JBatcher
from repro.data import seq_classification as jseq
from repro.kernels import ref as jref
from repro.launch.steps import galore_target_fn as jtarget
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.fed import FedConfig, FedEngine
from repro_torch.data import FederatedBatcher, seq_classification
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import galore_target_fn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from repro_torch.models.convert import params_from_jax
from repro_torch.utils import tree

ARCH = "rwkv6-1.6b"
TORCH_TOL = 1e-6         # plain backward vs torch autograd, fp32
JAX_TOL = 1e-5           # plain backward vs jax.vjp, fp32
GRAD_TOL = 1e-5          # layer and loss gradients vs jax.grad
C, T, BATCH, SEQ = 4, 2, 8, 16
# FedAvg-Full trains every target entry with dense Adam, whose first step
# moves an entry with a round-off-level gradient by up to ~0.1 lr in
# either package (test_torch_fed_methods.py): on the rwkv6 smoke model
# the port parts from JAX by 6.4e-4 in the losses and 3.4e-3 in D, and
# JAX from itself with its params scaled by 1 + 1e-7·N(0, 1) by 1.2e-3
# and 8.8e-3 (ROADMAP Queue 3 e).
LOSS_TOL = {"fedit": 1e-5, "fedavg_full": 1e-3}
DELTA_TOL = {"fedit": 1e-4, "fedavg_full": 5e-3}

_scan_mod = importlib.import_module("repro_torch.kernels.rwkv6_scan")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread: beside the other test
    workers, idle threads of a multi-threaded pool only compete for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _inputs(seed, b, l, h, d, with_state):
    """r, k, v ~ N(0, 0.5²), decays in (0, 1), u ~ N(0, 0.3²), and, with
    ``with_state``, s0 and ds_final; dy ~ N(0, 1). numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(-2.0 + 1.5 * rng.standard_normal((b, l, h, d)))
               ).astype(np.float32)
    u = 0.3 * rng.standard_normal((h, d)).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((b, h, d, d)).astype(np.float32)
          if with_state else None)
    dy = rng.standard_normal((b, l, h, d)).astype(np.float32)
    ds = (rng.standard_normal((b, h, d, d)).astype(np.float32)
          if with_state else None)
    return r, k, v, w, u, s0, dy, ds


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30)) if want.size else 0.0


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _autograd(r, k, v, w, u, s0, dy, ds, scan=tref.rwkv6_scan_ref):
    """Torch autograd through ``scan``: the cotangents of (r, k, v, w, u,
    s0) for the loss Σ y·dy + Σ s_final·ds."""
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    s0 = None if s0 is None else s0.clone().requires_grad_()
    y, s = scan(*leaves, s0)
    loss = (y.float() * dy.float()).sum()
    if ds is not None:
        loss = loss + (s * ds).sum()
    wrt = leaves + ([s0] if s0 is not None else [])
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return y, [torch.zeros_like(x) if g is None else g
               for x, g in zip(wrt, grads)]


# --------------------------------------------------------- the backward ----

_CASES = [(l, d, st) for l in (1, 7, 67) for d in (16, 64)
          for st in (False, True)]


@pytest.mark.parametrize("l,d,with_state", _CASES)
def test_bwd_ref_matches_torch_autograd(l, d, with_state):
    r, k, v, w, u, s0, dy, ds = (_t(x) for x in
                                 _inputs(l + d, 2, l, 2, d, with_state))
    _, want = _autograd(r, k, v, w, u, s0, dy, ds)
    got = tref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, ds)
    assert [x.dtype for x in got] == [torch.float32] * 6
    assert got[4].shape == (2, d) and got[5].shape == (2, 2, d, d)
    for g, x in zip(got, want):
        assert _rel(g.numpy(), x.numpy()) <= TORCH_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,d,with_state", _CASES)
def test_bwd_ref_matches_jax_vjp(l, d, with_state, dtype):
    r, k, v, w, u, s0, dy, ds = _inputs(l + d, 2, l, 2, d, with_state)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jr, jk, jv = (jnp.asarray(x).astype(jdt) for x in (r, k, v))
    jw, ju = jnp.asarray(w), jnp.asarray(u)
    js0 = jnp.asarray(s0) if with_state else jnp.zeros((2, 2, d, d))

    def f(r_, k_, v_, w_, u_, s0_):
        return jref.rwkv6_scan_ref(r_, k_, v_, w_, u_, s0_)

    _, vjp = jax.vjp(f, jr, jk, jv, jw, ju, js0)
    jds = jnp.asarray(ds) if with_state else jnp.zeros((2, 2, d, d))
    want = vjp((jnp.asarray(dy).astype(jdt), jds))
    got = tref.rwkv6_scan_bwd_ref(
        _t(r, tdt), _t(k, tdt), _t(v, tdt), _t(w), _t(u),
        _t(s0) if with_state else None, _t(dy, tdt),
        _t(ds) if with_state else None)
    for i, (g, x) in enumerate(zip(got, want)):
        x = np.asarray(jnp.asarray(x, jnp.float32))
        assert g.dtype == (tdt if i < 3 else torch.float32)
        err = float(np.max(np.abs(g.float().numpy() - x)))
        scale = float(np.max(np.abs(x)))
        tol = (_bf16_ulp(scale) if g.dtype == torch.bfloat16
               else JAX_TOL * scale)
        assert err <= tol, (i, err, tol)


def test_bwd_ref_of_an_empty_sequence():
    """L = 0: no step, so ds0 = ds_final and every other cotangent is
    zero or empty."""
    r, k, v, w, u, s0, dy, ds = (_t(x) for x in _inputs(5, 2, 0, 2, 64,
                                                         True))
    dr, dk, dv, dw, du, ds0 = tref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy,
                                                      ds)
    assert dr.shape == dk.shape == dv.shape == dw.shape == (2, 0, 2, 64)
    assert torch.equal(du, torch.zeros(2, 64)) and torch.equal(ds0, ds)


def test_bwd_ref_keeps_the_kernels_arithmetic_order():
    """The plain backward computes, bit for bit, the order
    csrc/rwkv6_scan_bwd.cu is written in, spelled out here in numpy
    float32 for one (b, h): each product and sum rounded on its own, each
    sum over j, over i and v·dy the tree of adjacent pairs over 64."""
    r, k, v, w, u, s0, dy, ds = _inputs(9, 1, 5, 1, 64, True)
    f = np.float32

    def tree64(x):                           # pairwise over axis 0
        while x.shape[0] > 1:
            x = (x[0::2] + x[1::2]).astype(f)
        return x[0]

    S = [s0[0, 0]]
    for t in range(5):
        kv = (k[0, t, 0, :, None] * v[0, t, 0, None, :]).astype(f)
        S.append((w[0, t, 0, :, None] * S[-1] + kv).astype(f))
    g, du = ds[0, 0].copy(), np.zeros(64, f)
    uu = u[0]
    got = tref.rwkv6_scan_bwd_ref(*(_t(x) for x in
                                    (r, k, v, w, u, s0, dy, ds)))
    for t in reversed(range(5)):
        rt, kt, vt, wt, dyt = (x[0, t, 0] for x in (r, k, v, w, dy))
        a = (rt[:, None] * dyt[None, :]).astype(f)
        dkv = (g + (uu[:, None] * a).astype(f)).astype(f)
        vdy = tree64((vt * dyt).astype(f))
        dr = (tree64((S[t] * dyt[None, :]).astype(f).T)
              + ((uu * kt).astype(f) * vdy).astype(f)).astype(f)
        dk = tree64((dkv * vt[None, :]).astype(f).T)
        dv = tree64((kt[:, None] * dkv).astype(f))
        dw = tree64((g * S[t]).astype(f).T)
        du = (du + ((rt * kt).astype(f) * vdy).astype(f)).astype(f)
        g = ((wt[:, None] * g).astype(f) + a).astype(f)
        want = {0: dr, 1: dk, 2: dv, 3: dw}
        for i, x in want.items():
            assert np.array_equal(got[i][0, t, 0].numpy(), x), (t, i)
    assert np.array_equal(got[4][0].numpy(), du)
    assert np.array_equal(got[5][0, 0].numpy(), g)


def test_checkpoints_are_the_walked_states():
    """``every``: the plain forward's checkpoint output is the state before
    steps 0, 8, 16, …, and its y and final state are the serving mode's
    bit for bit."""
    r, k, v, w, u, s0, _, _ = (_t(x) for x in _inputs(3, 2, 19, 2, 64,
                                                      True))
    y, s = tref.rwkv6_scan_ref(r, k, v, w, u, s0)
    y8, s8, ck = tref.rwkv6_scan_ref(r, k, v, w, u, s0, every=8)
    assert torch.equal(y, y8) and torch.equal(s, s8)
    assert ck.shape == (2, 2, 3, 64, 64) and torch.equal(ck[:, :, 0], s0)
    _, s_8 = tref.rwkv6_scan_ref(r[:, :8], k[:, :8], v[:, :8], w[:, :8], u,
                                 s0)
    assert torch.equal(ck[:, :, 1], s_8)


# ------------------------------------------------ ops dispatch, autograd ----

def test_ops_scan_differentiates_through_the_plain_pair():
    """On CPU tensors that require grad, ``ops.rwkv6_scan`` records the
    autograd Function with the plain pair: y bit for bit the plain
    forward's, and the cotangents of r, k, v, w, u and s0 those of torch
    autograd through ``rwkv6_scan_ref``."""
    r, k, v, w, u, s0, dy, ds = (_t(x) for x in _inputs(11, 2, 13, 2, 64,
                                                        True))
    y_want, want = _autograd(r, k, v, w, u, s0, dy, ds)
    y_got, got = _autograd(r, k, v, w, u, s0, dy, ds, scan=tops.rwkv6_scan)
    assert torch.equal(y_got, y_want)
    for g, x in zip(got, want):
        assert _rel(g.numpy(), x.numpy()) <= TORCH_TOL
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w)]
    y, _ = tops.rwkv6_scan(*leaves, u, s0)
    assert type(y.grad_fn).__name__ == "_Rwkv6ScanBackward"


def test_ops_scan_without_grad_records_nothing():
    """With no input that requires grad, or under no_grad, the forward
    runs alone as before: no graph, bit for bit the plain version."""
    r, k, v, w, u, s0, _, _ = (_t(x) for x in _inputs(12, 2, 9, 2, 64,
                                                      True))
    want = tref.rwkv6_scan_ref(r, k, v, w, u, s0)
    for ctx in (torch.enable_grad, torch.no_grad):
        with ctx():
            rr = r.clone().requires_grad_(ctx is torch.no_grad)
            got = tops.rwkv6_scan(rr, k, v, w, u, s0)
        assert all(x.grad_fn is None for x in got)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ops_scan_on_the_card_path_keeps_the_gradient(monkeypatch):
    """The dispatch a CUDA tensor takes, with the two kernel wrappers
    replaced by stand-ins that, like the kernels, return tensors with no
    graph: under grad the forward runs in its checkpoint mode, the
    backward through ``rwkv6_scan_bwd`` from those checkpoints, and the
    cotangents are torch autograd's through ``rwkv6_scan_ref``. Without
    grad the forward runs alone, with no checkpoints."""
    calls = []

    def fwd(r, k, v, w, u, s0=None, *, chunk=128, checkpoints=False):
        calls.append(("fwd", checkpoints))
        with torch.no_grad():
            return tref.rwkv6_scan_ref(
                r, k, v, w, u, s0,
                every=_scan_mod.CKPT_EVERY if checkpoints else 0)

    def bwd(r, k, v, w, u, ckpt, dy, ds_final=None):
        calls.append(("bwd", tuple(ckpt.shape)))
        return tref.rwkv6_scan_bwd_ref(r, k, v, w, u, ckpt[:, :, 0], dy,
                                       ds_final)

    monkeypatch.setattr(_scan_mod, "rwkv6_scan", fwd)
    monkeypatch.setattr(_scan_mod, "rwkv6_scan_bwd", bwd)
    monkeypatch.setattr(tops, "_kernel", lambda t: True)
    r, k, v, w, u, s0, dy, ds = (_t(x) for x in _inputs(13, 2, 21, 2, 64,
                                                        True))
    y_want, want = _autograd(r, k, v, w, u, s0, dy, ds)
    y_got, got = _autograd(r, k, v, w, u, s0, dy, ds, scan=tops.rwkv6_scan)
    assert calls == [("fwd", True), ("bwd", (2, 2, 3, 64, 64))]
    assert torch.equal(y_got, y_want)
    for g, x in zip(got, want):
        assert _rel(g.numpy(), x.numpy()) <= TORCH_TOL
    calls.clear()
    with torch.no_grad():
        tops.rwkv6_scan(r.requires_grad_(), k, v, w, u, s0)
    assert calls == [("fwd", False)]


# ------------------------------------------- the kernel's plan, on CPU ----

def test_bwd_plan_of_the_training_shape():
    """rwkv6-1.6b's training layer, (4, 128, 32, 64): one block a (b, h),
    16 chunks of 8 steps, one a checkpoint of the forward's checkpoint
    mode (ceil(L / 8), none at L = 0, as many as the plain forward
    writes); 512 threads of 8 columns, whose rows tile the 64 rows once,
    in shared memory a block may take."""
    p = _scan_mod.bwd_plan(4, 128, 32)
    assert (p.steps, p.chunks, p.cols, p.lanes, p.rows_per_warp, p.threads,
            p.warps, p.blocks, p.stages) == (8, 16, 8, 8, 4, 512, 16, 128, 3)
    assert p.smem <= _scan_mod.SMEM_OPTIN
    assert p.lanes * p.cols == 64 and p.rows_per_warp * p.warps == 64
    rows = sorted(_bwd_owner(t)[0] for t in range(p.threads))
    assert rows == sorted(list(range(64)) * p.lanes)
    assert _scan_mod.bwd_plan(1, 0, 2).chunks == 0
    for l in (1, 8, 9, 19):
        r, k, v, w, u, s0, _, _ = (_t(x) for x in _inputs(3, 1, l, 2, 16,
                                                          True))
        ck = tref.rwkv6_scan_ref(r, k, v, w, u, s0,
                                 every=_scan_mod.CKPT_EVERY)[2]
        assert ck.shape[2] == _scan_mod.bwd_plan(1, l, 2).chunks


# The backward kernel's map from a thread of its 512 to the entries of
# ∂L/∂S it holds (csrc/rwkv6_scan_bwd.cu), spelled out to emulate its
# sums: 64 rows of 8 lanes, 8 columns a lane, 4 rows a warp.
BWD_THREADS, BWD_COLS, BWD_LANES = 512, 8, 8


def _bwd_owner(thread: int):
    """(row, first column) of ∂L/∂S that a backward thread holds: row
    ``thread // 8``, columns [8·(thread % 8), +8); a row or column at or
    past D is padding."""
    return thread // BWD_LANES, BWD_COLS * (thread % BWD_LANES)


def _bwd_dv_columns(thread: int):
    """The two columns whose sum over its warp's 4 rows a backward thread
    holds after the rows' reduce-scatter (bit l of its row keeps the upper
    half at level l, of 8, then 4 columns)."""
    row, c0 = _bwd_owner(thread)
    sigma = sum(((BWD_COLS >> lv) // 2) * ((row >> lv) & 1)
                for lv in range(2))
    return c0 + sigma, c0 + sigma + 1


def _bwd_role(thread: int):
    """Which of the row's sums (0 dr, 1 dk, 2 dw) the lanes' reduce-scatter
    leaves on a thread, or None: lane q % 4 = 0, 2, 1 for q < 4."""
    q = thread % BWD_LANES
    return {0: 0, 2: 1, 1: 2}.get(q) if q < 4 else None


def test_bwd_threads_hold_every_entry_once():
    """The 512 threads (``_bwd_owner``) hold each (row, column) of ∂L/∂S
    once; after the rows' reduce-scatter each warp holds every column's
    sum over its 4 rows once (``_bwd_dv_columns``); after the lanes'
    reduce-scatter each row's dr, dk and dw sit on one lane each
    (``_bwd_role``)."""
    held = np.zeros((64, 64), np.int64)
    for t in range(BWD_THREADS):
        row, c0 = _bwd_owner(t)
        held[row, c0:c0 + BWD_COLS] += 1
    assert (held == 1).all()
    for warp in range(BWD_THREADS // 32):
        ts = range(32 * warp, 32 * warp + 32)
        got = [c for t in ts for c in _bwd_dv_columns(t)]
        assert sorted(got) == list(range(64))
        assert {_bwd_owner(t)[0] for t in ts} == set(range(4 * warp,
                                                         4 * warp + 4))
    for row in range(64):
        roles = [_bwd_role(t) for t in range(BWD_THREADS)
                 if _bwd_owner(t)[0] == row]
        assert sorted(x for x in roles if x is not None) == [0, 1, 2]


def _tree(vals):
    """Adjacent pairs until one is left (the in-thread tree)."""
    vals = list(vals)
    while len(vals) > 1:
        vals = [vals[a] + vals[a + 1] for a in range(0, len(vals), 2)]
    return vals[0]


def _emulate_row_sums(x3):
    """A row's three sums (x3: dr's, dk's, dw's 64 column products) as the
    kernel takes them: each lane's 8 columns as adjacent pairs, then
    ``lanes_reduce_scatter`` — at lane bit 0 the even lane keeps (dr, dk)
    and the odd one (dw, 0), at bit 1 each keeps one of its two, at bit 2
    the halves are added. Returns {lane: its sum}."""
    part = {q: [_tree(x[8 * q:8 * q + 8]) for x in x3] + [0.0]
            for q in range(BWD_LANES)}
    lv1 = {}
    for q in range(BWD_LANES):
        mine, other = part[q], part[q ^ 1]
        if q & 1:
            lv1[q] = [mine[2] + other[2], mine[3] + other[3]]
        else:
            lv1[q] = [mine[0] + other[0], mine[1] + other[1]]
    z = {q: lv1[q][(q >> 1) & 1] + lv1[q ^ 2][(q >> 1) & 1]
         for q in range(BWD_LANES)}
    return {q: z[q] + z[q ^ 4] for q in range(BWD_LANES)}


def _emulate_dv(x):
    """The sum over 64 rows of x (64, 64) as the kernel takes it: within
    each warp's 4 rows the reduce-scatter of ``rows_reduce_scatter`` (keep
    half, add the partner row's other half, twice), each thread left with
    the two columns ``_bwd_dv_columns`` names; then the 16 warps' partials
    as a tree of adjacent pairs."""
    red = torch.zeros((BWD_THREADS // 32, 64))
    for warp in range(BWD_THREADS // 32):
        part = {}
        for t in range(32 * warp, 32 * warp + 32):
            row, c0 = _bwd_owner(t)
            part[t] = list(x[row, c0:c0 + BWD_COLS])
        for lv in range(2):
            half = (BWD_COLS >> lv) // 2
            new = {}
            for t, mine in part.items():
                hi = (_bwd_owner(t)[0] >> lv) & 1
                sent = part[t ^ (BWD_LANES << lv)]
                lo = half if hi else 0
                new[t] = [mine[lo + c] + sent[lo + c] for c in range(half)]
            part = new
        for t, vals in part.items():
            for c, val in zip(_bwd_dv_columns(t), vals):
                red[warp, c] = val
    return _tree(red)


def _emulate_vdy(v, dy):
    """v · dy of one step as the staging takes it: each warp holds 32
    adjacent leaves and sums their products by an xor butterfly (every
    lane left with the half's sum); the step's two halves are added where
    they are read."""
    prod = v * dy
    halves = []
    for h in range(2):
        lane = list(prod[32 * h:32 * h + 32])
        m = 1
        while m < 32:
            lane = [lane[a] + lane[a ^ m] for a in range(32)]
            m *= 2
        assert all(torch.equal(val, lane[0]) for val in lane)
        halves.append(lane[0])
    return halves[0] + halves[1]


def _decades(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape)
                             * 10.0 ** rng.uniform(-4, 4, shape))
                            .astype(np.float32))


def _bits(x):
    return x.reshape(-1).view(torch.int32)


def test_bwd_reduction_orders_are_the_pairwise_sum():
    """The kernel's sums, emulated in torch fp32, are bitwise the plain
    version's trees: a row's dr, dk, dw over j on the lanes ``_bwd_role``
    names (``_row_sum``), dv's sum over i and v · dy
    (``_pairwise_sum``). Inputs span eight decades, so any other order
    rounds differently."""
    x3 = [_decades(5 + m, (64, 64)) for m in range(3)]
    rows = [tref._row_sum(x) for x in x3]
    for i in range(64):
        for q, val in _emulate_row_sums([x[i] for x in x3]).items():
            role = _bwd_role(q)
            if role is not None:
                assert torch.equal(_bits(val), _bits(rows[role][i]))
    assert torch.equal(_bits(_emulate_dv(x3[0])),
                       _bits(tref._pairwise_sum(x3[0])))
    v, dy = _decades(9, (64,)), _decades(10, (64,))
    assert torch.equal(_bits(_emulate_vdy(v, dy)),
                       _bits(tref._pairwise_sum((v * dy)[:, None])[0]))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       group=st.sampled_from([1, 2, 4, 8, 16, 32, 64]),
       width=st.integers(1, 5))
def test_pairwise_sum_is_the_tree_of_its_aligned_groups(seed, group, width):
    """``_pairwise_sum`` over 64 rows equals the tree of the sums of its
    aligned groups of ``group`` rows — every group the backward cuts a
    sum into (a thread's 8 columns, 32 of a row's across lane bits 0–1, a
    warp's 4 rows, a warp's 32 leaves of v · dy) and more — bit for bit,
    over eight decades."""
    x = _decades(seed, (64, width))
    parts = tref._pairwise_sum(x.reshape(64 // group, group, width))
    got = tref._pairwise_sum(parts) if group < 64 else parts
    assert torch.equal(_bits(got), _bits(tref._pairwise_sum(x)))


def _emulate_bwd_schedule(l):
    """The backward kernel's chunk schedule for an L-step call, followed
    step by step: the prologue stages the last two chunks and recomputes
    the last one's states into slots 0 … cnt - 1; then each chunk n, last
    first, is walked from its buffer (n % 2) and slots (mirrored when
    (last - n) is odd), the chunk before it recomputed into the slots the
    walk frees, from buffer (n + 1) % 2, and chunk n - 2 staged into
    buffer n % 2 after the walk. Returns the (chunk, step) whose state
    each walk step read, in walk order, and asserts that each buffer
    holds the chunk read from it."""
    k = _scan_mod.CKPT_EVERY
    nck = -(-l // k)
    reads, slots, buf = [], {}, {}
    if nck == 0:
        return reads
    last = nck - 1
    buf[last % 2] = last
    if last > 0:
        buf[(last - 1) % 2] = last - 1
    for s in range(l - last * k):
        slots[s] = (last, s)
    for n in range(last, -1, -1):
        c = min(k, l - n * k)
        flip = (last - n) & 1
        assert buf[n % 2] == n
        if n > 0:
            assert buf[(n + 1) % 2] == n - 1
        for s in range(k - 1, -1, -1):
            slot = k - 1 - s if flip else s
            if s < c:
                reads.append(slots[slot])
            slots[slot] = (n - 1, k - 1 - s)
        if n >= 2:
            buf[n % 2] = n - 2
    return reads


@pytest.mark.parametrize("l", [1, 7, 8, 9, 13, 16, 24, 67, 128])
def test_bwd_ring_walks_the_forward_states_in_order(l):
    """The kernel's pipeline (``_emulate_bwd_schedule``): every step t =
    L-1 … 0 reads the state before step t (chunk t // 8, step t % 8) from
    the ring, once, though the ring holds one chunk's states and runs
    mirrored every other chunk; every walk and recompute reads the buffer
    its chunk was staged into."""
    k = _scan_mod.CKPT_EVERY
    want = [(t // k, t % k) for t in range(l - 1, -1, -1)]
    assert _emulate_bwd_schedule(l) == want


@pytest.mark.parametrize("l,chunk,rkv", [(300, 128, 2), (300, 128, 4),
                                         (300, 20, 2), (129, 64, 2),
                                         (100, 128, 2), (5, 3, 2)])
def test_checkpoint_mode_stages_whole_intervals(l, chunk, rkv):
    """In the checkpoint mode a sequence longer than a slot stages a
    multiple of CKPT_EVERY steps (the kernel refuses anything else), so
    every checkpoint falls on a group's first step; shorter ones keep the
    serving mode's plan."""
    p = _scan_mod.plan(2, l, 32, 64, chunk, 132, rkv, 4, ckpt=True)
    serving = _scan_mod.plan(2, l, 32, 64, chunk, 132, rkv, 4)
    if l <= serving.staged:
        assert p == serving
    else:
        assert p.staged % _scan_mod.CKPT_EVERY == 0
        assert p.staged <= max(serving.staged, _scan_mod.CKPT_EVERY)
    assert p.smem <= _scan_mod.SMEM_OPTIN
    assert _scan_mod.CKPT_EVERY % p.group == 0


def test_bwd_wrapper_refuses_cpu_and_bad_operands():
    """The CUDA wrapper launches or raises: CPU tensors and a checkpoint
    tensor of the wrong shape are refused before any build."""
    r, k, v, w, u, s0, dy, _ = (_t(x) for x in _inputs(2, 1, 9, 2, 64,
                                                       True))
    ck = torch.zeros(1, 2, 2, 64, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        _scan_mod.rwkv6_scan_bwd(r, k, v, w, u, ck, dy)
    with pytest.raises(ValueError, match="ckpt"):
        _scan_mod.rwkv6_scan_bwd(r, k, v, w, u, ck[:, :, :1], dy)
    assert _scan_mod.rwkv6_scan_bwd.launches == 0


# ------------------------------------------------------------ the model ----

def _layer_setup(seed=3):
    """The smoke config's time- and channel-mix params from JAX's init,
    with a bonus, decays and lerps spread out (the init has u = 0), x and
    a cotangent for the output."""
    jcfg = jsmoke(jget_config(ARCH))
    d, dff = jcfg.d_model, jcfg.d_ff
    h = jrwkv.rwkv_heads(d)
    kt, kc = jax.random.split(jax.random.PRNGKey(seed))
    tp = jrwkv.time_mix_init(kt, d)
    cp = jrwkv.channel_mix_init(kc, d, dff)
    rng = np.random.default_rng(seed)
    tp["bonus_u"] = jnp.asarray(0.5 * rng.standard_normal((h, 64)),
                                jnp.float32)
    tp["decay_base"] = jnp.asarray(rng.uniform(-4, 1, d), jnp.float32)
    tp["mu"] = jnp.asarray(rng.uniform(0, 1, (5, d)), jnp.float32)
    cp["mu"] = jnp.asarray(rng.uniform(0, 1, (2, d)), jnp.float32)
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    cot = rng.standard_normal((2, 11, d)).astype(np.float32)
    return jcfg, tp, cp, x, cot


def _grads_match(jfn, tfn, params, x, cot):
    """jax.grad and torch autograd of Σ f(params, x)·cot over the params
    and x, each within GRAD_TOL of its scale."""
    jg = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * cot),
                  argnums=(0, 1))(params, jnp.asarray(x))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    leaves, tdef = tree.tree_flatten(tp)
    leaves = [t.clone().requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out = tfn(tdef.unflatten(leaves), tx)
    (out * torch.from_numpy(cot)).sum().backward()
    jl = jax.tree_util.tree_leaves(jg[0])
    assert len(jl) == len(leaves)
    for t, j in zip(leaves + [tx], jl + [jg[1]]):
        assert t.grad is not None
        assert _rel(t.grad.numpy(), np.asarray(j)) <= GRAD_TOL


def test_time_mix_gradients_match_jax():
    jcfg, tp, _, x, cot = _layer_setup()
    d = jcfg.d_model
    _grads_match(
        lambda p, xx: jrwkv.time_mix_forward(
            p, xx, jrwkv.rwkv_state_init(2, d), d),
        lambda p, xx: trwkv.time_mix_forward(
            p, xx, trwkv.rwkv_state_init(2, d), d), tp, x, cot)


def test_channel_mix_gradients_match_jax():
    jcfg, _, cp, x, cot = _layer_setup(4)
    d = jcfg.d_model
    _grads_match(
        lambda p, xx: jrwkv.channel_mix_forward(
            p, xx, jrwkv.rwkv_state_init(2, d)),
        lambda p, xx: trwkv.channel_mix_forward(
            p, xx, trwkv.rwkv_state_init(2, d)), cp, x, cot)


def test_lift_free_leaf_carries_the_gradient():
    """A time-mix target leaf as a LowRankDelta (a lift-free round's
    read): the gradients of its delta R̃ and of its norm probe are JAX's."""
    jcfg, tp, _, x, cot = _layer_setup(5)
    d = jcfg.d_model
    rng = np.random.default_rng(5)
    basis = np.linalg.qr(rng.standard_normal((d, 4)))[0].astype(np.float32)
    rt = (0.01 * rng.standard_normal((d, 4))).astype(np.float32)
    w = np.asarray(tp["wr"])

    def jfn(leaf, xx):
        p = dict(tp, wr=jlayers.LowRankDelta(w, basis, leaf[0], leaf[1],
                                             jnp.float32(0.99)))
        return jrwkv.time_mix_forward(p, xx, jrwkv.rwkv_state_init(2, d), d)

    jg = jax.grad(lambda lf: jnp.sum(jfn(lf, jnp.asarray(x)) * cot))(
        (jnp.asarray(rt), jnp.zeros(())))
    tp_t = params_from_jax(jax.tree_util.tree_map(np.asarray, tp), "cpu")
    trt = torch.from_numpy(rt).requires_grad_()
    nsq = torch.zeros(()).requires_grad_()
    tp_t["wr"] = tlayers.LowRankDelta(torch.from_numpy(w),
                                      torch.from_numpy(basis), trt, nsq,
                                      torch.tensor(0.99))
    out = trwkv.time_mix_forward(tp_t, torch.from_numpy(x),
                                 trwkv.rwkv_state_init(2, d), d)
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(trt.grad.numpy(), np.asarray(jg[0])) <= GRAD_TOL
    assert _rel(nsq.grad.numpy(), np.asarray(jg[1])) <= GRAD_TOL


@pytest.fixture(scope="module")
def smoke():
    jcfg = jsmoke(jget_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, tcfg, jparams, tparams


def test_loss_fn_and_gradients_match_jax(smoke, monkeypatch):
    """The rwkv6-1.6b smoke ``loss_fn`` (2 layers, d 128) and the gradient
    of every leaf against JAX's, masked labels included; the training
    forward writes no recurrent state."""
    jcfg, tcfg, jparams, tparams = smoke

    def no_write(buf, value):
        raise AssertionError("the training forward wrote a state")

    monkeypatch.setattr(trwkv, "_write", no_write)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lab[:, :4] = -1
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jcfg, jb))(
        jparams)
    leaves, tdef = tree.tree_flatten(tparams)
    leaves = [x.clone().requires_grad_() for x in leaves]
    tl = tmodel.loss_fn(tdef.unflatten(leaves), tcfg,
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab)})
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(leaves)
    for x, g in zip(leaves, jleaves):
        assert _rel(x.grad.numpy(), np.asarray(g)) <= GRAD_TOL
    logits, aux = tmodel.forward(tparams, tcfg, torch.from_numpy(tok))
    jlogits, _ = jmodel.forward(jparams, jcfg, jnp.asarray(tok))
    assert _rel(logits.detach().numpy(), np.asarray(jlogits)) <= 1e-5
    assert float(aux) == 0.0


# -------------------------------------------------- FedIT, FedAvg-Full ----

@pytest.mark.parametrize("method", ["fedit", "fedavg_full"])
def test_fed_round_matches_jax(smoke, method):
    """Two rounds of a LoRA method (its adapters reach ``dense`` as merged
    LoRA products) and of FedAvg-Full on the rwkv6 smoke model: per-step
    losses and the trainables' change D = leaf − start against JAX's."""
    jcfg, tcfg, jparams, tparams = smoke
    fkw = dict(method=method, rank=4, lr=3e-3, local_steps=T)
    je = JFedEngine(JFedConfig(**fkw),
                    loss_fn=lambda p, b: jmodel.loss_fn(p, jcfg, b),
                    params=jparams, target_fn=jtarget(jcfg))
    te = FedEngine(FedConfig(**fkw),
                   loss_fn=lambda p, b: tmodel.loss_fn(p, tcfg, b),
                   params=tparams, target_fn=galore_target_fn(tcfg))
    jb = JBatcher(jseq(256, 4, SEQ, jcfg.vocab_size), C, BATCH, alpha=0.5)
    tb = FederatedBatcher(seq_classification(256, 4, SEQ, tcfg.vocab_size),
                          C, BATCH, alpha=0.5)
    start = [np.asarray(x) for x in
             jax.tree_util.tree_leaves(je.global_trainable)]
    for _ in range(2):
        jbatch, tbatch = jb.round_batches(T), tb.round_batches(T)
        jm = je.run_round({k: jnp.asarray(v) for k, v in jbatch.items()})
        tm = te.run_round(tbatch)
        assert np.max(np.abs(tm["local_loss"].numpy()
                             - np.asarray(jm["local_loss"]))) \
            <= LOSS_TOL[method]
    jt = [np.asarray(x) for x in jax.tree_util.tree_leaves(je.global_trainable)]
    tt = [x.detach().numpy() for x in tree.tree_leaves(te.global_trainable)]
    assert len(jt) == len(tt) == (16 if method == "fedit" else 8)
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(tt, jt))
    den = sum(float(np.sum((w - s) ** 2)) for w, s in zip(jt, start))
    assert (num / den) ** 0.5 <= DELTA_TOL[method]


# ------------------------------------------------------------- the CLI ----

def test_train_cli_runs_rwkv_smoke_on_cpu(monkeypatch):
    """``launch/train.py --arch rwkv6-1.6b --smoke --device cpu`` runs two
    rounds with finite losses; every local step records the scan's
    autograd Function once a layer, and the no-grad evaluation none."""
    applied = []
    orig = tops._Rwkv6Scan.apply

    def count(*a):
        applied.append(1)
        return orig(*a)

    monkeypatch.setattr(tops._Rwkv6Scan, "apply", count)
    rows = ttrain.main(["--arch", ARCH, "--smoke", "--rounds", "2",
                        "--clients", "2", "--local-steps", "2", "--batch",
                        "4", "--seq", "16", "--examples", "64", "--classes",
                        "4", "--rank", "4", "--lr", "3e-3", "--device",
                        "cpu"])
    assert [r["round"] for r in rows] == [0, 1]
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("local_loss", "val_loss", "val_acc"))
    layers = smoke_variant(get_config(ARCH)).n_layers
    assert len(applied) == 2 * 2 * 2 * layers     # rounds, clients, steps
