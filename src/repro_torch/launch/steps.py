"""Step functions of the federated runtime and of serving (port of
``repro/launch/steps.py``).

The train step is the paper's client workload: one FedGaLore local step —
dense gradients on the target modules, GaLoreAdamW update in the rank-r
subspace, frozen base weights.

``make_fed_round_step`` builds a *whole round* (Algorithm 1): T local
steps per client, FedAvg aggregation 𝒜 over the clients and the
server-side state filter 𝒮 (Algorithm 1, line 12) — factored on the
projected ṽ (shared-basis rounds) or via heterogeneous-basis r×r transfer
Grams (``refresh_mode='svd'``, diverged bases) — followed by the
synced-state install and the seed bump for the next round. Passing
``state_sync=None`` builds the legacy 𝒯→𝒜 round (raw end-of-round states
returned; the caller syncs).

Client memory model (as ``core.fed``): with the default
``factored_clients=True`` every client's round state is the rank-r
factored accumulator ``R_i`` around the broadcast global base, and with
the default ``lift_free=True`` the local step is lift-free: target leaves
enter the model as ``models.layers.LowRankDelta`` nodes
(``kernels.ops.lowrank_linear`` on the card) whose backward returns the
``R_i`` gradient in rank-r coordinates. ``lift_free=False`` keeps the
transient-lift read ``base_scale·W + lift(R_i)``, and ``refresh_mode='svd'``
forces it (data-driven refreshes need the dense per-client gradient), as
does MLA with blockwise attention (the gate in :func:`make_fed_round_step`).
The transient read runs the fused preconditioner
(``kernels.ops.galore_precond_step``) on each shape bucket. In-step
seeded-random refreshes fire at ``count % refresh_every == 0``. The
factored client path requires every refresh to land on local step 0
(where R_i ≡ 0): ``refresh_every % local_steps == 0``; otherwise the dense
client round (kept under ``factored_clients=False`` as the parity oracle)
is used.

The local loops, the attack-and-quarantine guard, factored 𝒜 and the
𝒮 blocks are ``core.fed``'s round pieces, the ones ``FedEngine`` runs;
this module makes the runtime's round-level choices around them.
Client-stacked optimizer states carry (C, …) leaves and the GaLore count
and seed as host ints (``core.galore.stack_opt_state``). Clients run one
after another: the reference's ``vmap`` over the client mesh axes, its
``lax.scan`` over local steps and its ``client_chunk`` streaming only
reschedule the same arithmetic and have no counterpart here, nor does
its bucketed/per-leaf 𝒮 switch (𝒮 is bucketed, as in ``core.fed``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..core import aggregation as agg_lib
from ..core import fed as fed_lib
from ..core import galore as gal
from ..core.fed import _index, merge_dense, split_trainable
from ..models import model as model_lib
from ..utils import tree

PyTree = Any


def galore_target_fn(cfg: ArchConfig) -> Callable:
    """The paper's target modules, adapted per family: attention +
    dense-MLP projections; Mamba in/out projections; RWKV6 time-mix/
    channel-mix matrices. Experts, routers, embeddings frozen."""

    def fn(path: str, leaf) -> bool:
        if leaf.ndim < 2:
            return False
        if "embed" in path or "lm_head" in path:
            return False
        if "/moe/" in path or "/shared/" in path:
            return False
        last = path.split("/")[-1]
        if "/attn/" in path or "/mlp/" in path:
            # Stacked scan-block layout: the projection weights are the 3-D
            # (nb, m, n) leaves; the 2-D leaves under these prefixes are
            # stacked bias/norm vectors, which stay frozen.
            return leaf.ndim >= 3
        if "/mamba/" in path:
            return last in ("in_proj", "out_proj")
        if "/tmix/" in path:
            return last in ("wr", "wk", "wv", "wg", "wo")
        if "/cmix/" in path:
            return last in ("wk", "wv", "wr")
        return False

    return fn


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """The reference's ``TrainSpec`` without the fields that pick a TPU
    kernel or a placement (``fused``, ``use_pallas``, ``client_axes``)."""
    rank: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    refresh_every: int = 200
    local_steps: int = 8                # T (round step only)
    seed: int = 0
    refresh_mode: str = "random"        # production steady-state step
    # Lift-free factored local steps (module docstring); False keeps the
    # transient-lift read.
    lift_free: bool = True


def make_galore_cfg(spec: TrainSpec) -> gal.GaloreConfig:
    return gal.GaloreConfig(rank=spec.rank, refresh_every=spec.refresh_every,
                            adaptive_steps=0, refresh_mode=spec.refresh_mode)


def make_galore_tx(cfg: ArchConfig, spec: TrainSpec):
    return gal.galore_adamw(make_galore_cfg(spec), spec.lr, spec.weight_decay,
                            target_fn=lambda p, l: True,  # trainable tree is
                            seed=spec.seed,               # already filtered
                            clip_norm=spec.clip_norm)


def init_train_state(cfg: ArchConfig, spec: TrainSpec, seed: int = 0,
                     device="cuda"):
    """(trainable, frozen, opt_state) for ONE client, from
    ``model.init_params(cfg, seed, device)``."""
    params = model_lib.init_params(cfg, seed=seed, device=device)
    trainable, frozen = split_trainable(params, galore_target_fn(cfg))
    opt_state = make_galore_tx(cfg, spec).init(trainable)
    return trainable, frozen, opt_state


def _stack(trees):
    return tree.tree_map(lambda *xs: torch.stack(xs), *trees)


def make_fed_local_step(cfg: ArchConfig, spec: TrainSpec,
                        n_clients: int) -> Callable:
    """One GaLoreAdamW local step for every client.

    Args (client-stacked leaves marked ×C):
      trainable ×C, frozen (shared), opt_state ×C (``galore.
      stack_opt_state`` layout: the GaLore count/seed are host ints),
      batch {tokens ×C (C, b, L), labels ×C, embeds? ×C}
    Returns (trainable ×C, opt_state ×C, loss (C,)).
    """
    tx = make_galore_tx(cfg, spec)

    def client_step(trainable, frozen, opt_state, batch):
        return fed_lib.dense_local_step(
            tx, lambda t: model_lib.loss_fn(merge_dense(frozen, t), cfg,
                                            batch), trainable, opt_state)

    def step(trainable, frozen, opt_state, batch):
        outs = [client_step(_index(trainable, c), frozen,
                            gal.opt_state_row(opt_state, c), _index(batch, c))
                for c in range(n_clients)]
        return (_stack([o[0] for o in outs]),
                gal.stack_opt_states([o[1] for o in outs]),
                torch.stack([o[2].float() for o in outs]))

    return step


def sync_client_states(out_st, w, n_clients: int, state_sync: str,
                       factored: bool, bases_shared: bool,
                       exclude_zero_weights: bool = False,
                       robust_agg: str = "none",
                       robust_trim: float = 0.2,
                       robust_iters: int = 8,
                       robust_tol: float = 1e-6):
    """Server-side 𝒮 + next-round install on client-stacked optimizer
    states (the tail of the fused round; also the legacy round's 𝒮).

    Synchronizes each adapted block's projected ṽ — factored on the shared
    seeded basis, or via heterogeneous r×r transfer Grams when client
    bases diverged (``bases_shared=False``), or through the dense
    per-client lift oracle (``factored=False``) — installs the result in
    every client slot, and bumps the round seed. Shape-identical leaves
    sync as one batched program (``state_sync.map_sync_leaves``).
    ``exclude_zero_weights`` (the participation-masked round) drops
    zero-weight clients from the AJIVE joint-basis estimate;
    ``robust_agg`` is robust 𝒮 (the weighted means over the projected
    moment stacks become the robust estimator; ``'none'`` is exactly the
    plain reductions)."""
    g_stack = gal.galore_state_of(out_st)
    if state_sync != "none":
        vs, bs, treedef = fed_lib.client_uplink(out_st)
        if factored:
            # the shared seeded basis cancels: no (C, m, n) lift and no
            # (n, n) projector, only the O(dim·r) projected state; diverged
            # bases (data-driven refreshes) close the lift → 𝒮 →
            # re-project round trip over r×r transfer Grams
            synced = tree.tree_leaves(fed_lib.sync_factored(
                state_sync, out_st, w, hetero=not bases_shared,
                exclude_zero_weights=exclude_zero_weights,
                robust=robust_agg, trim=robust_trim, iters=robust_iters,
                tol=robust_tol), is_leaf=lambda x: x is None)
        else:
            synced = [None if v is None else
                      fed_lib.dense_sync_block(state_sync, v, b, w)
                      for v, b in zip(vs, bs)]
        # every client slot holds the synced projected state, clamped at 0
        # (a broadcast view of the O(dim·r) buffer until the install
        # copies it)
        out = [None if s is None else
               torch.clamp(s, min=0.0).expand((n_clients,) + s.shape)
               for s in synced]
        g_new = gal.with_projected_v(g_stack, treedef.unflatten(out))
    else:
        g_new = g_stack
    g_new = gal.GaloreState(count=g_new.count, seed=g_new.seed + 1,
                            blocks=g_new.blocks)
    return gal.replace_galore_state(out_st, g_new)


def make_fed_round_step(cfg: ArchConfig, spec: TrainSpec, n_clients: int,
                        state_sync: Optional[str] = None,
                        factored_sync: bool = True,
                        factored_clients: bool = True,
                        lift_free: Optional[bool] = None,
                        exclude_zero_weights: bool = False,
                        robust_agg: str = "none",
                        quarantine: bool = False,
                        quarantine_zmax: float = 6.0,
                        robust_trim: float = 0.2,
                        robust_iters: int = 8,
                        robust_tol: float = 1e-6,
                        return_weights: bool = False) -> Callable:
    """A full federated round (Algorithm 1):

      broadcast (clients start from the shared global base) → T local
      GaLoreAdamW steps per client → 𝒜: factored ``base_scale·W + Σ wᵢ
      lift(Rᵢ)`` (or the dense weighted mean over the client axis under
      ``factored_clients=False``) → 𝒮 (when ``state_sync`` is a protocol
      name): sync of the projected second moments, install + seed bump;
      the returned states are ready for the next round.

    ``factored_clients`` selects the rank-r factored client memory model
    (module docstring); it requires in-step refreshes to land on local
    step 0 (``refresh_every % local_steps == 0``) and every trainable leaf
    to be a target block, falling back to the dense client round
    otherwise. ``lift_free`` (None = ``spec.lift_free``) additionally runs
    the factored local phase lift-free; off for ``refresh_mode='svd'`` and
    for MLA with blockwise attention. ``state_sync=None`` is the legacy
    𝒯→𝒜 round: raw end-of-round states are returned and the caller runs
    𝒮. ``exclude_zero_weights`` is the participation-masked variant: the
    caller feeds pre-masked weights (zero for non-participants — the
    normalization renormalizes over the participants) and 𝒮 drops the
    zero-weight clients from the AJIVE joint basis. ``quarantine`` /
    ``robust_agg`` are the guarded variant (as ``core.fed``): after the
    local phase every client's factored uplink is screened (non-finite,
    or norm above ``quarantine_zmax`` × the weighted median) and failures
    fold into the zero-weight mask path; ``robust_agg`` swaps the weighted
    mean of 𝒜 and 𝒮 for a robust reduction. Both require the factored
    client round; an honest cohort through them is the unguarded round
    bitwise.

    The returned ``round_step(global_trainable, frozen, opt_states,
    batches, weights, attack=None)`` takes batches with leading (C, T, …)
    axes, and an optional ``attack``: the (C,) per-client corruption
    multiplier applied to each client's factored accumulators and
    projected moments after the local phase, before the screen. It
    returns ``(new_global, states, losses (C, T), v_upload)`` (``v_upload``
    None when 𝒮 ran), and the post-quarantine renormalized weights last
    with ``return_weights``.
    """
    tx = make_galore_tx(cfg, spec)
    gcfg = make_galore_cfg(spec)
    if robust_agg not in agg_lib.ROBUST_MODES:
        raise ValueError(f"robust_agg={robust_agg!r} not in "
                         f"{agg_lib.ROBUST_MODES}")
    guard = quarantine or robust_agg != "none"
    # Factored deltas are exact only while the basis is fixed whenever any
    # R_i ≠ 0, i.e. refreshes only at local step 0 (count ≡ 0 mod τ there).
    factored_ok = (factored_clients
                   and spec.refresh_every % spec.local_steps == 0)
    # Lift-free needs every in-step refresh to be seeded-random (the hoisted
    # refresh never sees a gradient): 'svd' mode keeps the transient read.
    # MLA with blockwise attention reads kv_b once per chunk, which breaks
    # the clip-norm probe's exactness (per-use ‖·‖² sum misses cross-chunk
    # terms — models.layers.lowrank_apply): keep the transient read there.
    if lift_free is None:
        lift_free = spec.lift_free
    multi_read = (cfg.attn_chunk and any(
        mix == "mla" for mix, _ in cfg.layer_kinds()))
    liftfree_ok = (lift_free and spec.refresh_mode != "svd"
                   and not multi_read)

    def loss_at(frozen):
        return lambda batch: lambda t: model_lib.loss_fn(
            merge_dense(frozen, t), cfg, batch)

    def local_phase_factored(global_trainable, frozen, opt_states, batches):
        """(C, …) states and batches → (C, …) factored deltas, end-of-round
        states, losses (C, T) and per-client base scales (C,)."""
        outs = [fed_lib.factored_local_train(
                    gcfg, loss_at(frozen), global_trainable,
                    gal.opt_state_row(opt_states, c), _index(batches, c),
                    spec.local_steps, not liftfree_ok, lr=spec.lr,
                    weight_decay=spec.weight_decay, clip_norm=spec.clip_norm)
                for c in range(n_clients)]
        return (_stack([o[0] for o in outs]),
                gal.stack_opt_states([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]),
                torch.stack([o[3] for o in outs]))

    def local_phase_dense(global_trainable, frozen, opt_states, batches):
        """The dense local phase (the parity-oracle client model: each
        client trains its own copy of the trainables)."""
        outs = [fed_lib.dense_local_train(
                    tx, loss_at(frozen), global_trainable,
                    gal.opt_state_row(opt_states, c), _index(batches, c),
                    spec.local_steps)
                for c in range(n_clients)]
        return (_stack([o[0] for o in outs]),
                gal.stack_opt_states([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    def round_step(global_trainable, frozen, opt_states, batches, weights,
                   attack=None):
        w = weights / torch.sum(weights)
        use_factored = (factored_ok and gal.all_blocks_projected(
            gal.galore_state_of(opt_states)))
        if attack is not None and not use_factored:
            raise ValueError("the attack operand requires the factored "
                             "client round")
        if use_factored:
            out_d, out_st, losses, base_scales = local_phase_factored(
                global_trainable, frozen, opt_states, batches)
            if attack is not None or quarantine:
                out_d, out_st, base_scales, w, _ = fed_lib.guard_uplink(
                    out_d, out_st, base_scales, w, attack, quarantine,
                    quarantine_zmax)
            # 𝒜 factored: reduce in projected coordinates (shared seeded
            # basis) or contract per-client lifts ('svd' diverges bases)
            new_global = fed_lib.aggregate_factored(
                global_trainable, out_d, out_st, base_scales, w,
                hetero=spec.refresh_mode == "svd", robust=robust_agg,
                trim=robust_trim, iters=robust_iters, tol=robust_tol)
        else:
            if guard:
                raise ValueError(
                    "quarantine/robust_agg require the factored client "
                    "round (factored_clients with step-0-aligned refreshes "
                    "and all-target trainables)")
            out_tr, out_st, losses = local_phase_dense(
                global_trainable, frozen, opt_states, batches)
            # 𝒜: the weighted average over the client axis
            new_global = tree.tree_map(
                lambda x: torch.tensordot(w, x.float(), dims=([0], [0]))
                .to(x.dtype), out_tr)
        if state_sync is not None:
            # 𝒮 in the round: the returned states are next-round-ready. A
            # quarantine-guarded round excludes zero-weight clients from
            # the joint basis even unmasked (a no-op on positive weights).
            out_st = sync_client_states(
                out_st, w, n_clients, state_sync, factored=factored_sync,
                bases_shared=(spec.refresh_mode != "svd"),
                exclude_zero_weights=exclude_zero_weights or quarantine,
                robust_agg=robust_agg, robust_trim=robust_trim,
                robust_iters=robust_iters, robust_tol=robust_tol)
            v_upload = None
        else:
            # the host-side filter's payload: the projected second moments
            v_upload = gal.extract_projected_v(gal.galore_state_of(out_st))
        if return_weights:
            return new_global, out_st, losses, v_upload, w
        return new_global, out_st, losses, v_upload

    return round_step


def make_prefill_step(cfg: ArchConfig, cache_len: int) -> Callable:
    def prefill_step(params, tokens, embeds=None):
        state = model_lib.init_decode_state(cfg, tokens.shape[0], cache_len,
                                            device=tokens.device)
        return model_lib.prefill(params, cfg, tokens, state, embeds)
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def decode(params, token, state):
        return model_lib.decode_step(params, cfg, token, state)
    return decode
