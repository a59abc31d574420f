"""Federated fine-tuning engine for the GaLore methods — 𝒯 / 𝒜 / 𝒮 (port of
``repro/core/fed.py``, paper §3, Alg. 1).

  ==================  ===========  ==============  =======
  method              optimizer 𝒯  aggregation 𝒜   sync 𝒮
  ==================  ===========  ==============  =======
  fedgalore_minus     GaLoreAdamW  dense avg       none
  fedgalore           GaLoreAdamW  dense avg       AJIVE(ṽ)
  fedgalore_avg       GaLoreAdamW  dense avg       avg(ṽ)
  fedgalore_avg_svd   GaLoreAdamW  dense avg       avg_svd(ṽ)
  ==================  ===========  ==============  =======

One round (:meth:`FedEngine.run_round`), as the reference's fused round
computes it:

1. InitState (Eq. 5): fresh moments, the synced ṽ of the last round
   installed, the seeded projector refresh for round k (seed ``s_k =
   seed + k``, count ``k·T``) — identical for every client.
2. T local GaLore steps per client, clients one after another. A client
   holds only rank-r factored state: the accumulator ``R_i`` (shaped like
   the projected moments), its moments and basis, and the scalar
   ``base_scale = (1-ηλ)^t`` — never a dense weight copy.
   - Round 0 with adaptive refreshes reads ``base_scale·W + lift(R_i)``
     transiently (its in-step refresh at count 0 is an RSVD of each
     client's own dense gradient) and runs the fused preconditioner on the
     stacked buckets (``kernels.ops.galore_precond_step``).
   - Every later round is lift-free: target leaves enter the loss as
     ``models.layers.LowRankDelta`` nodes (``kernels.ops.lowrank_linear``
     forward, projected-cotangent backward), and the step consumes the
     projected gradients with the projection skipped.
3. 𝒜: ``(Σ wᵢ sᵢ)·W + Σ wᵢ lift(Rᵢ, Bᵢ)`` per target leaf — per-client
   bases in round 0, one shared basis after.
4. 𝒮 in projected coordinates, one batched program per shape bucket
   (``core.state_sync``; AJIVE's Phase-1 eigensolves through
   ``kernels.ops.batched_small_eigh``).

The reference's ``jit``/``vmap``/``scan``/donation become eager loops, so
its execution knobs (``fused_round``, ``client_chunk``, ``pipeline_sync``,
donation) have no counterpart; the round counter and step counts are host
ints, and the round-0 choice is Python control flow. Not ported: the LoRA
and dense methods and the eager dense-𝒮 oracle round (ROADMAP Queue 1
item 8); participation masks, attacks, quarantine and robust aggregation
(item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import aggregation as agg
from . import galore as gal
from . import projector as proj
from . import state_sync as sync_lib
from ..utils import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FedMethodSpec:
    name: str
    trainable: str          # 'galore'
    optimizer: str          # 'galore_adamw'
    aggregation: str        # 'dense_avg'
    state_sync: str         # 'none' | 'avg' | 'avg_svd' | 'ajive'


METHODS: Dict[str, FedMethodSpec] = {
    "fedgalore": FedMethodSpec("fedgalore", "galore", "galore_adamw",
                               "dense_avg", "ajive"),
    "fedgalore_minus": FedMethodSpec("fedgalore_minus", "galore",
                                     "galore_adamw", "dense_avg", "none"),
    "fedgalore_avg": FedMethodSpec("fedgalore_avg", "galore", "galore_adamw",
                                   "dense_avg", "avg"),
    "fedgalore_avg_svd": FedMethodSpec("fedgalore_avg_svd", "galore",
                                       "galore_adamw", "dense_avg",
                                       "avg_svd"),
}
# The reference's LoRA and dense methods (ROADMAP Queue 1 item 8).
UNPORTED_METHODS = ("fedavg_full", "fedit", "ffa_lora", "lora_fair", "flora",
                    "fr_lora")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """The reference's ``FedConfig`` fields that mean something for the
    GaLore methods here; ``participation``, ``robust_agg`` and
    ``quarantine`` exist to refuse what is not ported."""
    method: str = "fedgalore"
    rank: int = 8
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0   # Assumption 3.8 (bounded G)
    local_steps: int = 8               # T
    adaptive_refreshes: int = 2        # S (SVD->random schedule)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    seed: int = 0
    participation: Optional[Any] = None
    robust_agg: str = "none"
    quarantine: bool = False


_ITEM8 = "ROADMAP Queue 1 item 8: LoRA baselines and the dense oracle round"
_ITEM10 = "ROADMAP Queue 1 item 10: population and robustness"


def _check_config(cfg: FedConfig) -> None:
    if cfg.method in UNPORTED_METHODS:
        raise NotImplementedError(f"method {cfg.method!r} is not ported yet "
                                  f"({_ITEM8})")
    if cfg.method not in METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.participation is not None:
        raise NotImplementedError(f"participation is not ported yet "
                                  f"({_ITEM10})")
    if cfg.robust_agg not in agg.ROBUST_MODES:
        raise ValueError(f"robust_agg={cfg.robust_agg!r} not in "
                         f"{agg.ROBUST_MODES}")
    if cfg.quarantine or cfg.robust_agg != "none":
        raise NotImplementedError(f"quarantine/robust_agg are not ported yet "
                                  f"({_ITEM10})")


# ------------------------------------------------------------ trainables ----

def split_trainable(params: PyTree, target_fn) -> tuple:
    """dense/galore trainable: the target matrix leaves themselves (2-D, or
    3-D stacked scan blocks — one projector per layer); the rest frozen."""
    leaves, treedef = tree.tree_flatten_with_path(params)
    train, frozen = [], []
    for path, p in leaves:
        if p.ndim in (2, 3) and target_fn(tree.path_str(path), p):
            train.append(p)
            frozen.append(None)
        else:
            train.append(None)
            frozen.append(p)
    return treedef.unflatten(train), treedef.unflatten(frozen)


def merge_dense(frozen: PyTree, trainable: PyTree) -> PyTree:
    return tree.tree_map(lambda f, t: t if f is None else f, frozen,
                         trainable, is_leaf=lambda x: x is None)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in batch.items()}


# -------------------------------------------------------------- the engine --

class FedEngine:
    """Federated simulation of the GaLore methods. ``loss_fn(params, batch)
    -> scalar tensor``; ``params`` sit on the device the rounds run on."""

    def __init__(self, cfg: FedConfig, loss_fn: Callable, params: PyTree,
                 target_fn: Callable = None, eval_fn: Callable = None):
        _check_config(cfg)
        self.cfg = cfg
        self.spec = METHODS[cfg.method]
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.target_fn = target_fn or (lambda p, x: True)
        self.global_trainable, self.frozen = split_trainable(params,
                                                             self.target_fn)
        leaves = tree.tree_leaves(self.global_trainable)
        if not leaves:
            raise ValueError(
                f"target_fn selected no trainable leaves for method "
                f"'{cfg.method}' — nothing to train or aggregate")
        self.device = leaves[0].device
        self.galore_cfg = gal.GaloreConfig(
            rank=cfg.rank, refresh_every=10 ** 9,   # engine refreshes itself
            adaptive_steps=cfg.adaptive_refreshes, b1=cfg.b1, b2=cfg.b2,
            eps=cfg.eps, refresh_mode="auto")
        self.tx = gal.galore_adamw(self.galore_cfg, cfg.lr, cfg.weight_decay,
                                   seed=cfg.seed, clip_norm=cfg.clip_norm)
        # tx.init depends only on the trainables' shapes and the seed, so
        # the fresh state every InitState starts from is built once.
        self._fresh_opt = self.tx.init(self.global_trainable)
        if not gal.all_blocks_projected(gal.galore_state_of(self._fresh_opt)):
            raise NotImplementedError(
                "a trainable leaf that is no GaLore target block needs dense "
                f"per-client state ({_ITEM8})")
        self.round_idx = 0
        self.synced_v = None        # projected ṽ init from 𝒮
        self._client_state = None   # (C, ·) factored accumulators, last round
        self._client_opt = None     # (C, ·) optimizer states, last round

    # -------------------------------------------------------------- 𝒯 -------
    def _trainable_loss(self, trainable, batch):
        return self.loss_fn(merge_dense(self.frozen, trainable), batch)

    def _init_state0(self, round_idx: int, synced_v):
        """The round-start InitState (Eq. 5), identical for every client:
        fresh moments, the synced ṽ installed, the seeded refresh for
        round ``round_idx``."""
        st = self._fresh_opt
        g = gal.galore_state_of(st)
        g = gal.with_seed(g, self.cfg.seed + round_idx)          # s_k
        g = g._replace(count=round_idx * self.cfg.local_steps)
        if synced_v is not None:
            g = gal.with_projected_v(g, synced_v)
        g = gal.manual_refresh(self.galore_cfg, g, round_idx)
        return gal.replace_galore_state(st, g)

    def _round0_adaptive(self) -> bool:
        """Whether round 0's in-step refresh is data-driven (RSVD of each
        client's own dense gradient) — the case the lift-free read cannot
        serve, so round 0 takes the transient-lift read."""
        return (self.galore_cfg.adaptive_steps > 0
                and self.galore_cfg.refresh_mode != "random")

    def _step(self, grads, st, dl, scale):
        c = self.cfg
        with torch.no_grad():
            return gal.factored_adamw_step(
                self.galore_cfg, grads, st, dl, scale, lr=c.lr,
                weight_decay=c.weight_decay, clip_norm=c.clip_norm)

    def _local_train(self, st, batches, transient: bool):
        """T factored local steps of one client from InitState ``st``.
        ``transient``: every step reads ``base_scale·W + lift(R_i)`` and
        differentiates the dense leaves; else the lift-free read. Returns
        (deltas, opt_state, losses (T,), base_scale)."""
        dl = gal.zero_client_deltas(gal.galore_state_of(st))
        scale = torch.ones((), dtype=torch.float32, device=self.device)
        losses = []
        for t in range(self.cfg.local_steps):
            batch = {k: v[t] for k, v in batches.items()}
            if transient:
                with torch.no_grad():
                    tr = gal.lift_client_trainable(
                        self.global_trainable, dl, gal.galore_state_of(st),
                        scale)
                leaves, tdef = tree.tree_flatten(tr)
                leaves = [x.requires_grad_(True) for x in leaves]
                loss = self._trainable_loss(tdef.unflatten(leaves), batch)
                grads = tdef.unflatten(torch.autograd.grad(loss, leaves))
            else:
                g0 = gal.maybe_refresh_instep(self.galore_cfg,
                                              gal.galore_state_of(st))
                st = gal.replace_galore_state(st, g0)
                loss, grads = gal.liftfree_value_and_grad(
                    lambda tr: self._trainable_loss(tr, batch),
                    self.global_trainable, dl, g0, scale)
            dl, scale, st = self._step(grads, st, dl, scale)
            losses.append(loss.detach().float())
        return dl, st, torch.stack(losses), scale

    # ------------------------------------------------------------ a round ---
    def run_round(self, client_batches: PyTree, weights=None, mask=None,
                  attack=None):
        """client_batches: dict of arrays with leading (K clients, T steps,
        ...) axes. Returns ``{"local_loss": (K, T) tensor,
        "mean_final_loss": float}`` and advances the engine's global
        state."""
        if mask is not None or attack is not None:
            raise NotImplementedError("participation masks and attack "
                                      f"injection are not ported yet "
                                      f"({_ITEM10})")
        batches = _to_device(client_batches, self.device)
        k_clients = next(iter(batches.values())).shape[0]
        w = sync_lib.normalize_weights(weights, k_clients,
                                       device=self.device)
        round_idx = self.round_idx
        st0 = self._init_state0(round_idx, self.synced_v)
        transient = round_idx == 0 and self._round0_adaptive()
        outs = [self._local_train(st0, {k: v[c] for k, v in batches.items()},
                                  transient) for c in range(k_clients)]
        out_d = tree.tree_map(lambda *xs: torch.stack(xs),
                              *[o[0] for o in outs])
        out_opt = gal.stack_opt_states([o[1] for o in outs])
        losses = torch.stack([o[2] for o in outs])
        scales = torch.stack([o[3] for o in outs])
        self.global_trainable = self._aggregate_factored(
            self.global_trainable, out_d, out_opt, scales, w, round_idx)
        if self._method_syncs():
            self.synced_v = self._sync_states(out_opt, w, round_idx)
        self._client_state, self._client_opt = out_d, out_opt
        self.round_idx += 1
        return {"local_loss": losses,                      # (K, T)
                "mean_final_loss": float(losses[:, -1].mean())}

    def run_rounds(self, round_batches: PyTree, weights=None, masks=None):
        """K rounds in order: round_batches has leading (K rounds, C
        clients, T steps, ...) axes. Returns ``local_loss`` (K, C, T)."""
        if masks is not None:
            raise NotImplementedError(f"participation masks are not ported "
                                      f"yet ({_ITEM10})")
        k_rounds = next(iter(round_batches.values())).shape[0]
        losses = torch.stack([
            self.run_round({k: v[r] for k, v in round_batches.items()},
                           weights)["local_loss"]
            for r in range(int(k_rounds))])
        return {"local_loss": losses,
                "mean_final_loss": float(losses[-1, :, -1].mean())}

    # -------------------------------------------------------------- 𝒜 -------
    def _round0_hetero(self, round_idx: int) -> bool:
        """Round 0 with adaptive refreshes leaves every client on its own
        data-driven basis; from round 1 on, bases are the seeded broadcast,
        identical across clients."""
        return round_idx == 0 and self._round0_adaptive()

    @torch.no_grad()
    def _aggregate_factored(self, global_trainable, out_deltas, out_opt,
                            base_scales, w, round_idx):
        """𝒜 for factored clients: ``(Σᵢ wᵢ sᵢ)·W + Σᵢ wᵢ lift(Rᵢ, Bᵢ)`` per
        target leaf."""
        bases = gal.extract_bases(gal.galore_state_of(out_opt))
        hetero = self._round0_hetero(round_idx)
        sbar = torch.einsum("c,c->", w, base_scales.float())

        def one(w0, d_stack, b_stack):
            side = (proj.RIGHT if d_stack.shape[-1] == b_stack.shape[-1]
                    else proj.LEFT)
            lifted = agg.robust_factored_lift(d_stack, b_stack, side, w,
                                              "none", hetero=hetero)
            return (sbar * w0.float() + lifted).to(w0.dtype)

        return tree.tree_map(one, global_trainable, out_deltas, bases)

    # -------------------------------------------------------------- 𝒮 -------
    def _method_syncs(self) -> bool:
        return self.spec.state_sync != "none"

    @torch.no_grad()
    def _sync_states(self, stacked_opt, w, round_idx):
        """Factored 𝒮: shared-basis rounds sync on the projected ṽ
        directly; the adaptive round 0 runs the heterogeneous-basis sync
        (r×r transfer Grams). One batched program per shape bucket."""
        g_stack = gal.galore_state_of(stacked_opt)
        v_tree = gal.extract_projected_v(g_stack)      # leaves (K, ., r)
        b_tree = gal.extract_bases(g_stack)            # leaves (K, dim, r)
        protocol = self.spec.state_sync
        hetero = self._round0_hetero(round_idx)

        def leaf_fn(v_stack, b_stack):
            rank = b_stack.shape[-1]
            side = proj.RIGHT if v_stack.shape[-1] == rank else proj.LEFT
            if hetero:
                return sync_lib.sync_block_hetero_factored(
                    protocol, v_stack, b_stack, side, w, rank)
            return sync_lib.sync_block_synced_factored(
                protocol, v_stack, side, w, rank)

        is_none = lambda x: x is None  # noqa: E731
        vs, treedef = tree.tree_flatten(v_tree, is_leaf=is_none)
        bs = tree.tree_leaves(b_tree, is_leaf=is_none)
        synced = sync_lib.map_sync_leaves(leaf_fn, vs, bs)
        return treedef.unflatten(synced)

    # ------------------------------------------------------------- helpers --
    def global_params(self) -> PyTree:
        return merge_dense(self.frozen, self.global_trainable)

    @torch.no_grad()
    def evaluate(self, batch) -> float:
        batch = _to_device(batch, self.device)
        fn = self.eval_fn or self.loss_fn
        return float(fn(self.global_params(), batch))
