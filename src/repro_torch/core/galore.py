"""GaLoreAdamW — gradient-subspace AdamW (port of ``repro/core/galore.py``).

For each target block ``W ∈ R^{m×n}`` the optimizer keeps a rank-r basis
and AdamW moments in the projected shape (``(m,r)`` right / ``(r,n)``
left), never dense ``m×n`` states:

    g̃ = project(g, B);  m̃ = β₁m̃ + (1-β₁)g̃;  ṽ = β₂ṽ + (1-β₂)g̃²
    ũ = m̂/(√v̂ + ε);  u = project_back(ũ, B);  W ← W − ηu − ηλW

The projector refreshes every ``τ`` steps: data-driven (RSVD/SVD of the
current gradient) for the first ``S`` refreshes, then seeded random — a
pure function of ``(s_k, refresh_idx, block_id)`` through the port's
threefry, so every basis is JAX's basis. On refresh the buffers change
basis with the r×r transfer ``B_oldᵀ B_new``.

The update is shape-bucketed: target blocks with identical
(shape, rank) stack into one bucket whose refresh and fused step run once
(``kernels.ops.galore_precond_step``: the CUDA kernel on the card, its
plain version on the CPU); the JAX package's per-leaf loop stays there as
the reference. Differences from the reference: the step count
and round seed are host ints (JAX carries traced scalars), and a refresh
decision is Python control flow where JAX has ``lax.cond``. Client-stacked
states (``stack_opt_state``) keep the counters as host ints; the vmap/scan
layout helpers (``client_opt_axes``, ``chunk_opt_state``) have no
counterpart: the port runs clients one after another.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import projector as proj
from ..kernels import ops as kops
from ..kernels.galore_adamw import bias_corrections
from ..optim.base import (GradientTransformation, ScaleByLrState, chain,
                          clip_by_global_norm, global_norm,
                          scale_by_learning_rate)
from ..optim.adamw import add_decayed_weights
from ..utils import tree

PyTree = Any


class GaloreBlockState(NamedTuple):
    basis: torch.Tensor   # (dim, r) fp32, orthonormal columns
    m: torch.Tensor       # projected first moment, fp32
    v: torch.Tensor       # projected second moment, fp32 (elementwise)


class DenseMoments(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


class GaloreState(NamedTuple):
    count: int      # step counter
    seed: int       # round seed s_k (server-broadcast)
    blocks: PyTree  # per-leaf GaloreBlockState | DenseMoments


def _is_block(x) -> bool:
    return isinstance(x, (GaloreBlockState, DenseMoments))


def default_target_fn(path: str, leaf) -> bool:
    """Target = any matrix leaf; 3-D leaves are stacked scan blocks with one
    projector per layer (leading dim)."""
    return leaf.ndim in (2, 3)


@dataclasses.dataclass(frozen=True)
class GaloreConfig:
    rank: int = 8
    refresh_every: int = 200          # tau
    adaptive_steps: int = 2           # S data-driven refreshes, then random
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    oversample: int = 8
    use_exact_svd: bool = False
    # 'auto': refresh index picks RSVD vs random; 'random' / 'svd' pin one.
    refresh_mode: str = "auto"
    bias_correction: bool = True


def _block_rank(cfg: GaloreConfig, shape) -> int:
    return min(cfg.rank, min(shape[-2:]))


def _proj_shape(shape, rank: int, side: str):
    """Projected buffer shape, preserving leading stacked dims."""
    lead = tuple(shape[:-2])
    m, n = shape[-2:]
    return lead + ((m, rank) if side == proj.RIGHT else (rank, n))


def _block_keys(seed, refresh_idx, block_id, lead_shape, device):
    """One key for a 2-D block; per-layer keys for stacked (nb, m, n)
    blocks. ``block_id`` may be a tensor of ids (a bucket)."""
    key = proj.seeded_block_key(seed, refresh_idx, block_id, device=device)
    if not lead_shape:
        return key
    return proj.stacked_keys(key, lead_shape[0])


def galore_init(cfg: GaloreConfig, params: PyTree,
                target_fn: Callable = default_target_fn,
                seed: int = 0) -> GaloreState:
    leaves, treedef = tree.tree_flatten_with_path(params)
    block_states = []
    for block_id, (path, p) in enumerate(leaves):
        if target_fn(tree.path_str(path), p) and p.ndim >= 2:
            side = proj.proj_side(p.shape)
            r = _block_rank(cfg, p.shape)
            keys = _block_keys(seed, 0, block_id, tuple(p.shape[:-2]),
                               p.device)
            pshape = _proj_shape(p.shape, r, side)
            block_states.append(GaloreBlockState(
                basis=proj.random_basis(keys, proj.basis_dim(p.shape), r),
                m=torch.zeros(pshape, dtype=torch.float32, device=p.device),
                v=torch.zeros(pshape, dtype=torch.float32, device=p.device)))
        else:
            block_states.append(DenseMoments(
                m=torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                v=torch.zeros(p.shape, dtype=torch.float32, device=p.device)))
    return GaloreState(count=0, seed=int(seed),
                       blocks=treedef.unflatten(block_states))


def _new_basis(cfg: GaloreConfig, g32, keys, dim, rank, side, refresh_idx):
    """The refreshed basis: data-driven from ``g32`` (RSVD, or exact SVD)
    while ``refresh_idx < adaptive_steps`` under ``refresh_mode='auto'``,
    seeded random afterwards."""
    data = (cfg.refresh_mode == "svd" or
            (cfg.refresh_mode == "auto"
             and refresh_idx < cfg.adaptive_steps))
    if not data:
        return proj.random_basis(keys, dim, rank)
    if cfg.use_exact_svd:
        return proj.svd_basis(g32, rank, side)
    return proj.rsvd_basis(g32, rank, side, keys, cfg.oversample)


def _change_basis(m, v, old, new, side):
    """Moments onto the new basis; ṽ is clamped at 0 (Appendix A.1)."""
    return (proj.reproject(m, old, new, side),
            torch.clamp(proj.reproject(v, old, new, side), min=0.0))


def _projected_adam(cfg: GaloreConfig, gt, m, v, count: int):
    """The projected-space Adam chain: moment EMAs + (optionally
    bias-corrected) update direction, with the kernel's fp32 bias
    corrections."""
    m = cfg.b1 * m + (1 - cfg.b1) * gt
    v = cfg.b2 * v + (1 - cfg.b2) * gt * gt
    c1, c2 = bias_corrections(count, cfg.b1, cfg.b2, cfg.bias_correction)
    return m, v, (m / c1) / (torch.sqrt(v / c2) + cfg.eps)


def _dense_update(cfg: GaloreConfig, g, st: DenseMoments, count):
    m, v, u = _projected_adam(cfg, g.float(), st.m, st.v, count)
    return u, DenseMoments(m=m, v=v)


def _bucketed_update(cfg: GaloreConfig, g_leaves, blk_leaves, count,
                     refresh_idx, do_refresh, seed,
                     project_back: bool = True):
    """Shape-bucketed GaLore step: target blocks with identical (shape,
    rank) share one stacked bucket whose refresh and fused step
    (``kernels.ops.galore_precond_step``, one launch per bucket on the
    card) run once. Per-block seeded keys fold in the original leaf index,
    so every basis is the reference's per-leaf basis. ``project_back=False``
    keeps the update in projected coordinates (ũ, shaped like the
    moments) — the factored-delta client path."""
    updates = [None] * len(blk_leaves)
    new_blocks = [None] * len(blk_leaves)
    buckets: dict = {}
    for i, (g, st) in enumerate(zip(g_leaves, blk_leaves)):
        if isinstance(st, GaloreBlockState):
            buckets.setdefault((tuple(g.shape), int(st.basis.shape[-1])),
                               []).append(i)
        else:
            updates[i], new_blocks[i] = _dense_update(cfg, g, st, count)

    for (shape, rank), idxs in sorted(buckets.items()):
        side = proj.proj_side(shape)
        gs = torch.stack([g_leaves[i] for i in idxs])
        basis = torch.stack([blk_leaves[i].basis for i in idxs])
        m = torch.stack([blk_leaves[i].m for i in idxs])
        v = torch.stack([blk_leaves[i].v for i in idxs])
        if do_refresh:
            ids = torch.tensor(idxs, dtype=torch.int64, device=gs.device)
            keys = _block_keys(seed, refresh_idx, ids, shape[:-2],
                               gs.device)
            new = _new_basis(cfg, gs.float(), keys, proj.basis_dim(shape),
                             rank, side, refresh_idx)
            m, v = _change_basis(m, v, basis, new, side)
            basis = new
        # the kernel reads the stack in the gradients' own type (bf16 or
        # fp32, converted exactly in registers)
        u, m, v = kops.galore_precond_step(
            gs, basis, m, v, count, side=side, b1=cfg.b1, b2=cfg.b2,
            eps=cfg.eps, bias_correction=cfg.bias_correction,
            project_back=project_back)
        for j, i in enumerate(idxs):
            updates[i] = u[j]
            new_blocks[i] = GaloreBlockState(basis=basis[j], m=m[j], v=v[j])
    return updates, new_blocks


def galore_transform_update(cfg: GaloreConfig, grads, state: GaloreState,
                            project_back: bool = True,
                            projected: bool = False):
    """One GaLore preconditioning step (the ``scale_by_galore`` update
    body): in-step ``count % τ`` refresh, projected Adam moments, update
    direction — lifted to ambient shape (``project_back=True``) or left as
    the projected ũ (the factored-delta client path). Non-target
    (``DenseMoments``) leaves are plain Adam either way.

    ``projected=True`` is the lift-free consumption mode: the gradients
    arrive already in rank-r coordinates (the projected-cotangent backward
    of the delta-aware forward), so the projection is skipped and the step
    is pure projected-space Adam. The caller owns the refresh
    (:func:`maybe_refresh_instep` before the forward); every leaf must be a
    target block."""
    count = state.count + 1
    refresh_idx = state.count // cfg.refresh_every
    do_refresh = (state.count % cfg.refresh_every) == 0

    leaves, treedef = tree.tree_flatten_with_path(grads)
    blk_leaves = tree.tree_leaves(state.blocks, is_leaf=_is_block)
    if projected:
        updates, new_blocks = [], []
        for (path, g), st in zip(leaves, blk_leaves):
            if not isinstance(st, GaloreBlockState):
                raise ValueError(
                    "projected-gradient GaLore step requires every leaf to "
                    f"be a target block; {tree.path_str(path)} is dense")
            side = _moment_side(st)
            m, v, ut = _projected_adam(cfg, g.float(), st.m, st.v, count)
            updates.append(proj.project_back(ut, st.basis, side)
                           if project_back else ut)
            new_blocks.append(GaloreBlockState(basis=st.basis, m=m, v=v))
    else:
        updates, new_blocks = _bucketed_update(
            cfg, [g for _, g in leaves], blk_leaves, count, refresh_idx,
            do_refresh, state.seed, project_back=project_back)
    return (treedef.unflatten(updates),
            GaloreState(count=count, seed=state.seed,
                        blocks=treedef.unflatten(new_blocks)))


def scale_by_galore(cfg: GaloreConfig,
                    target_fn: Callable = default_target_fn,
                    seed: int = 0) -> GradientTransformation:
    """GaLore preconditioning as a GradientTransformation (chained with
    weight decay and lr like AdamW)."""

    def init(params):
        return galore_init(cfg, params, target_fn, seed)

    def update(grads, state, params=None):
        del params
        return galore_transform_update(cfg, grads, state, project_back=True)

    return GradientTransformation(init, update)


def galore_adamw(cfg: GaloreConfig, learning_rate, weight_decay: float = 0.01,
                 target_fn: Callable = default_target_fn, seed: int = 0,
                 clip_norm: Optional[float] = None) -> GradientTransformation:
    txs = []
    if clip_norm is not None:
        txs.append(clip_by_global_norm(clip_norm))
    txs += [scale_by_galore(cfg, target_fn, seed),
            add_decayed_weights(weight_decay),
            scale_by_learning_rate(learning_rate)]
    return chain(*txs)


def bucket_by_shape(keys):
    """Group leaf indices by an identical-shape key: ``keys[i]`` is a
    hashable layout descriptor for leaf i (or None to leave it unbucketed).
    Returns ``(buckets, passthrough)`` — a deterministically-ordered list of
    ``(key, [indices])`` plus the unbucketed indices."""
    groups: dict = {}
    passthrough = []
    for i, key in enumerate(keys):
        if key is None:
            passthrough.append(i)
        else:
            groups.setdefault(key, []).append(i)
    return sorted(groups.items()), passthrough


def _bucketed_manual_refresh(cfg: GaloreConfig, blk_leaves, grads_leaves,
                             refresh_idx, seed):
    """Shape-bucketed round-boundary refresh: blocks with identical (basis
    shape, moment shape) share one stacked key derivation, basis draw and
    r×r moment transfer. Keys fold the original leaf index."""
    out = [None] * len(blk_leaves)
    buckets, passthrough = bucket_by_shape(
        [(tuple(st.basis.shape), tuple(st.m.shape))
         if isinstance(st, GaloreBlockState) else None for st in blk_leaves])
    for i in passthrough:
        out[i] = blk_leaves[i]
    for (bshape, mshape), idxs in buckets:
        rank, dim, lead = bshape[-1], bshape[-2], bshape[:-2]
        side = proj.RIGHT if mshape[-1] == rank else proj.LEFT
        basis = torch.stack([blk_leaves[i].basis for i in idxs])
        m = torch.stack([blk_leaves[i].m for i in idxs])
        v = torch.stack([blk_leaves[i].v for i in idxs])
        ids = torch.tensor(idxs, dtype=torch.int64, device=basis.device)
        keys = _block_keys(seed, refresh_idx, ids, lead, basis.device)
        if grads_leaves is not None:
            g32 = torch.stack([grads_leaves[i] for i in idxs]).float()
            if cfg.use_exact_svd:
                new = proj.svd_basis(g32, rank, side)
            else:
                new = proj.rsvd_basis(g32, rank, side, keys, cfg.oversample)
        else:
            new = proj.random_basis(keys, dim, rank)
        m_new, v_new = _change_basis(m, v, basis, new, side)
        for j, i in enumerate(idxs):
            out[i] = GaloreBlockState(basis=new[j], m=m_new[j], v=v_new[j])
    return out


def manual_refresh(cfg: GaloreConfig, state: GaloreState, refresh_idx: int,
                   grads: Optional[PyTree] = None) -> GaloreState:
    """Refresh every block basis now (the engine's round-boundary refresh).
    Data-driven (RSVD/SVD of ``grads``) when ``grads`` is given and
    ``refresh_idx < adaptive_steps``; seeded random otherwise."""
    grads_leaves = None
    if grads is not None and cfg.refresh_mode != "random" and \
            int(refresh_idx) < cfg.adaptive_steps:
        grads_leaves = tree.tree_leaves(grads)
    blk_leaves, treedef = tree.tree_flatten(state.blocks, is_leaf=_is_block)
    out = _bucketed_manual_refresh(cfg, blk_leaves, grads_leaves,
                                   int(refresh_idx), state.seed)
    return GaloreState(count=state.count, seed=state.seed,
                       blocks=treedef.unflatten(out))


def maybe_refresh_instep(cfg: GaloreConfig, state: GaloreState
                         ) -> GaloreState:
    """Hoisted in-step refresh for the lift-free local step: fires on the
    dense path's predicate (``count % τ == 0``) before the forward, so the
    projected cotangent arrives on the refreshed basis. Seeded-random only
    (:func:`manual_refresh` with ``grads=None``)."""
    if state.count % cfg.refresh_every:
        return state
    return manual_refresh(cfg, state, state.count // cfg.refresh_every)


# --------------------------------------------- factored-delta client state --
#
# Within a federated round every GaLoreAdamW local update lives in the
# shared rank-r subspace (the projector refreshes only at local step 0,
# where the round-start delta is zero), so a client never holds a dense
# weight copy: its trainable state is the factored accumulator R_i (shaped
# like the projected moments) around the broadcast global base,
#
#     W_i(t) = base_scale(t) · W_global + lift(R_i(t), B_i),
#     base_scale(t) = (1 - η λ)^t,
#
# with decoupled weight decay absorbed into the scalar ``base_scale``.


def _moment_side(st: GaloreBlockState) -> str:
    """Projected buffers are (rows, r) right / (r, cols) left."""
    return proj.RIGHT if st.m.shape[-1] == st.basis.shape[-1] else proj.LEFT


def all_blocks_projected(state: GaloreState) -> bool:
    """Whether every trainable leaf is a GaLore target block — the
    precondition for the factored-delta client representation."""
    return all(isinstance(s, GaloreBlockState)
               for s in tree.tree_leaves(state.blocks, is_leaf=_is_block))


def zero_client_deltas(state: GaloreState) -> PyTree:
    """Round-start factored accumulators R_i = 0, shaped like the projected
    moments."""
    return tree.tree_map(lambda st: torch.zeros_like(st.m), state.blocks,
                         is_leaf=_is_block)


def lift_client_trainable(base: PyTree, deltas: PyTree, state: GaloreState,
                          base_scale) -> PyTree:
    """The transient dense weight read ``base_scale·W + lift(R_i, B_i)`` per
    target leaf — the only place a client's dense weights materialize."""
    def one(w0, d, st):
        lifted = proj.project_back(d, st.basis.float(), _moment_side(st))
        return (base_scale * w0.float() + lifted).to(w0.dtype)
    return tree.tree_map(one, base, deltas, state.blocks)


class LiftFreeGrads(NamedTuple):
    """Lift-free gradient bundle: per-leaf projected cotangents (moment
    shape) plus the exact squared dense-gradient norm probes that stand in
    for the dense leaves in global-norm clipping."""
    proj: PyTree    # g̃ per target leaf, shaped like the projected moments
    nsq: PyTree     # ‖dense g‖² per leaf (scalar, or (nb,) for stacked)


def liftfree_params(base: PyTree, deltas: PyTree, nsq: PyTree,
                    state: GaloreState, base_scale) -> PyTree:
    """The delta-context trainable tree: each target leaf becomes a
    :class:`models.layers.LowRankDelta` of (base W, basis, R̃, norm probe,
    base_scale broadcast per layer)."""
    from ..models.layers import LowRankDelta

    def one(w0, d, ns, st):
        lead = w0.shape[:-2]
        scale = torch.as_tensor(base_scale, dtype=torch.float32,
                                device=w0.device)
        return LowRankDelta(w=w0, basis=st.basis.float(), rt=d.float(),
                            nsq=ns, scale=scale.expand(lead))
    return tree.tree_map(one, base, deltas, nsq, state.blocks)


def liftfree_nsq0(deltas: PyTree) -> PyTree:
    """Zero norm probes, one per target leaf (per layer when stacked)."""
    return tree.tree_map(
        lambda d: torch.zeros(d.shape[:-2], dtype=torch.float32,
                              device=d.device), deltas)


def liftfree_value_and_grad(loss_of_params, base: PyTree, deltas: PyTree,
                            state: GaloreState, base_scale):
    """``(loss, LiftFreeGrads)`` for one lift-free local step: autograd wrt
    the rank-r accumulators (gradients arrive projected) and the norm
    probes (gradients arrive as exact dense-grad squared norms). Base
    weights, bases and scale get no gradient, so no dense m×n cotangent
    exists."""
    dl = tree.tree_map(lambda d: d.detach().requires_grad_(True), deltas)
    ns = tree.tree_map(lambda z: z.requires_grad_(True),
                       liftfree_nsq0(deltas))
    loss = loss_of_params(liftfree_params(base, dl, ns, state, base_scale))
    d_leaves, d_def = tree.tree_flatten(dl)
    n_leaves, n_def = tree.tree_flatten(ns)
    grads = torch.autograd.grad(loss, d_leaves + n_leaves)
    k = len(d_leaves)
    return loss.detach(), LiftFreeGrads(proj=d_def.unflatten(grads[:k]),
                                        nsq=n_def.unflatten(grads[k:]))


def factored_adamw_step(cfg: GaloreConfig, grads, opt_state, deltas,
                        base_scale, *, lr, weight_decay: float = 0.0,
                        clip_norm: Optional[float] = None):
    """One GaLoreAdamW local step in factored-delta coordinates: the
    :func:`galore_adamw` chain (global-norm clip → ``scale_by_galore`` →
    decoupled weight decay → lr) with the ambient lift eliminated,

        R_i ← R_i − η(ũ + λ R_i),   base_scale ← base_scale − η λ base_scale.

    ``grads`` are the dense per-leaf gradients (the transient-lift read) or
    a :class:`LiftFreeGrads` bundle (the lift-free read: projected
    gradients, clipping driven by the exact dense-norm probes). Returns
    ``(new_deltas, new_base_scale, new_opt_state)``."""
    states = [opt_state] if isinstance(opt_state, GaloreState) \
        else list(opt_state)
    new_states = list(states)
    lift_free = isinstance(grads, LiftFreeGrads)
    if lift_free:
        grads, nsq = grads.proj, grads.nsq
    if clip_norm is not None:
        if lift_free:
            gnorm = torch.sqrt(sum(torch.sum(x) for x in tree.tree_leaves(nsq)))
        else:
            gnorm = global_norm(grads)
        cscale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
        grads = tree.tree_map(lambda g: g.float() * cscale, grads)
    gi = next(i for i, s in enumerate(states) if isinstance(s, GaloreState))
    ut, new_states[gi] = galore_transform_update(cfg, grads, states[gi],
                                                 project_back=False,
                                                 projected=lift_free)
    step_lr = None
    for i, s in enumerate(states):
        if isinstance(s, ScaleByLrState):
            step_lr = lr(s.count) if callable(lr) else lr
            new_states[i] = ScaleByLrState(count=s.count + 1)
    if step_lr is None:
        if callable(lr):
            raise ValueError("a schedule lr needs the chain's ScaleByLrState "
                             "to supply the step count")
        step_lr = lr
    new_deltas = tree.tree_map(
        lambda d, u: d - step_lr * (u + weight_decay * d), deltas, ut)
    new_scale = base_scale - step_lr * weight_decay * base_scale
    if isinstance(opt_state, GaloreState):
        return new_deltas, new_scale, new_states[0]
    return new_deltas, new_scale, tuple(new_states)


# ------------------------------------------------- fed-layer state access ---

def map_opt_layout(opt_state, batched: Callable,
                   scalar: Callable = lambda x: x):
    """Map ``batched`` over the per-client leaves of a (possibly chained)
    optimizer state and ``scalar`` over the GaLore count/seed."""
    def per_state(s):
        if isinstance(s, GaloreState):
            return GaloreState(count=scalar(s.count), seed=scalar(s.seed),
                               blocks=tree.tree_map(batched, s.blocks))
        if isinstance(s, ScaleByLrState):
            return ScaleByLrState(count=scalar(s.count))
        return tree.tree_map(batched, s)

    if isinstance(opt_state, GaloreState):
        return per_state(opt_state)
    return tuple(per_state(s) for s in opt_state)


def stack_opt_states(states: list):
    """Stack per-client optimizer states along a new leading client axis;
    the counters (identical across clients) stay host ints."""
    first = states[0]
    leaves = [tree.tree_leaves(map_opt_layout(s, batched=lambda x: x,
                                              scalar=lambda _: None))
              for s in states]
    stacked = [torch.stack(col) for col in zip(*leaves)]
    it = iter(stacked)
    return map_opt_layout(first, batched=lambda _: next(it))


def stack_opt_state(opt_state, n_clients: int, copy: bool = False):
    """Broadcast one optimizer state along a new leading client axis; the
    counters stay host ints. ``copy=True`` gives every client its own
    buffers (an expanded view otherwise)."""
    def bcast(x):
        out = x.expand((n_clients,) + tuple(x.shape))
        return out.clone() if copy else out
    return map_opt_layout(opt_state, batched=bcast)


def opt_state_row(stacked, c: int):
    """Client ``c``'s optimizer state out of a client-stacked one."""
    return map_opt_layout(stacked, batched=lambda x: x[c])


def galore_state_of(opt_state) -> GaloreState:
    """Find the GaloreState inside a chained optimizer state."""
    if isinstance(opt_state, GaloreState):
        return opt_state
    for s in opt_state:
        if isinstance(s, GaloreState):
            return s
    raise ValueError("no GaloreState in optimizer state")


def replace_galore_state(opt_state, new: GaloreState):
    if isinstance(opt_state, GaloreState):
        return new
    return tuple(new if isinstance(s, GaloreState) else s for s in opt_state)


def extract_projected_v(state: GaloreState) -> PyTree:
    """The per-block projected second moments ṽ — the client uplink."""
    return tree.tree_map(
        lambda st: st.v if isinstance(st, GaloreBlockState) else None,
        state.blocks, is_leaf=_is_block)


def extract_bases(state: GaloreState) -> PyTree:
    return tree.tree_map(
        lambda st: st.basis if isinstance(st, GaloreBlockState) else None,
        state.blocks, is_leaf=_is_block)


def with_projected_v(state: GaloreState, new_v: PyTree) -> GaloreState:
    """Install the server-synchronized ṽ (next-round init, Alg. 1 l.13),
    clamped at 0."""
    def put(st, nv):
        if isinstance(st, GaloreBlockState) and nv is not None:
            return GaloreBlockState(basis=st.basis, m=st.m,
                                    v=torch.clamp(nv.float(), min=0.0))
        return st
    blocks = tree.tree_map(put, state.blocks, new_v, is_leaf=_is_block)
    return GaloreState(count=state.count, seed=state.seed, blocks=blocks)


def with_seed(state: GaloreState, seed: int) -> GaloreState:
    return GaloreState(count=state.count, seed=int(seed) & 0xFFFFFFFF,
                       blocks=state.blocks)
