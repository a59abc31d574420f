"""Federated fine-tuning engine — 𝒯 / 𝒜 / 𝒮 (port of
``repro/core/fed.py``, paper §3, Alg. 1). Each method is a
(trainable-kind, optimizer, aggregation, state-sync) 4-tuple per Table 1:

  =================  =========  ===========  ==============  =========
  method             trainable  optimizer 𝒯  aggregation 𝒜   sync 𝒮
  =================  =========  ===========  ==============  =========
  fedavg_full        dense      AdamW        dense avg       none
  fedit              LoRA(A,B)  Adam         factor avg      none
  ffa_lora           LoRA(B)    SGD          factor avg      none
  lora_fair          LoRA(A,B)  SGD          factor avg+ref  none
  flora              LoRA(A,B)  AdamW        lift ΔW, merge  none
  fr_lora            LoRA(A,B)  AdamW        lift ΔW, merge
                                             + rank-r refac  none
  fedgalore_minus    dense      GaLoreAdamW  dense avg       none
  fedgalore          dense      GaLoreAdamW  dense avg       AJIVE(ṽ)
  fedgalore_avg      dense      GaLoreAdamW  dense avg       avg(ṽ)
  fedgalore_avg_svd  dense      GaLoreAdamW  dense avg       avg_svd(ṽ)
  =================  =========  ===========  ==============  =========

A round (:meth:`FedEngine.run_round`) takes one of three forms, chosen as
the reference chooses them:

* **Factored clients** (GaLore methods whose every trainable leaf is a
  GaLore target block, ``factored_clients=True``; the default for them):
  1. InitState (Eq. 5): fresh moments, the synced ṽ of the last round
     installed, the seeded projector refresh for round k (seed ``s_k =
     seed + k``, count ``k·T``) — identical for every client.
  2. T local GaLore steps per client, clients one after another. A client
     holds only rank-r factored state: the accumulator ``R_i`` (shaped
     like the projected moments), its moments and basis, and the scalar
     ``base_scale = (1-ηλ)^t`` — never a dense weight copy. Round 0 with
     adaptive refreshes (and every round under ``lift_free=False``) reads
     ``base_scale·W + lift(R_i)`` transiently and runs the fused
     preconditioner on the stacked buckets
     (``kernels.ops.galore_precond_step``, ũ out); every other round is
     lift-free: target leaves enter the loss as
     ``models.layers.LowRankDelta`` nodes (``kernels.ops.lowrank_linear``).
  3. 𝒜: ``(Σ wᵢ sᵢ)·W + Σ wᵢ lift(Rᵢ, Bᵢ)`` per target leaf.
  4. 𝒮 in projected coordinates, one batched program per shape bucket
     (``core.state_sync``; AJIVE's Phase-1 eigensolves through
     ``kernels.ops.batched_small_eigh``).
* **Dense clients** (the LoRA and dense methods, and GaLore under
  ``factored_clients=False``): each client trains its own copy of the
  trainables — dense target leaves, or the LoRA pairs merged densely
  into the base (``merge_lora``) — for T steps of ``tx.update`` +
  ``apply_updates`` (for GaLore the fused preconditioner with the update
  projected back, ``galore_precond_step`` with ``project_back=True``);
  𝒜 reduces the stacked trainables (:meth:`FedEngine._aggregate_pure`;
  FLoRA and FR-LoRA also write the base); 𝒮 is step 4's.
* **The eager oracle** (``fused_round=False`` or ``factored_sync=False``):
  the dense-client round with :meth:`FedEngine._sync_states_eager`, the
  factored shared-basis 𝒮 where ``factored_sync`` holds and bases are
  shared, else the dense per-client lift (``state_sync.sync_lifted_views``,
  dense ``ajive``) re-projected onto client 0's basis.

The reference's ``jit``/``vmap``/``scan``/donation become eager loops, so
its execution knobs that only reschedule the same arithmetic
(``client_chunk``, ``pipeline_sync``, ``bucketed_sync``, donation, the
scan over rounds) have no counterpart; the round counter and step counts
are host ints, and the round-0 choice is Python control flow.

Participation and defense (:meth:`FedEngine.run_round`'s ``mask`` and
``attack``): a masked round keeps every cohort slot training, gives
masked-out clients zero renormalized weight in 𝒜 and excludes them from
the AJIVE joint basis in 𝒮. The guarded round (an attack, or a
``quarantine`` / ``robust_agg`` config; factored clients only) multiplies
each client's uplink by its attack entry, screens it
(:meth:`FedEngine._apply_guard`), and runs robust 𝒜 and exclusion-aware
robust 𝒮. A full mask and an all-ones attack take the unmasked path, and
an honest cohort through the guard is bitwise the unguarded round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import aggregation as agg
from . import galore as gal
from . import lora as lora_lib
from . import projector as proj
from . import state_sync as sync_lib
from .population import ParticipationConfig
from .. import optim as optim_lib
from ..utils import prng, tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FedMethodSpec:
    name: str
    trainable: str          # 'dense' | 'lora' | 'lora_b' | 'galore'
    optimizer: str          # 'sgd' | 'sgdm' | 'adam' | 'adamw' | 'galore_adamw'
    aggregation: str        # 'dense_avg'|'factor_avg'|'fair'|'lift_merge'|'lift_refac'
    state_sync: str         # 'none' | 'avg' | 'avg_svd' | 'ajive'


METHODS: Dict[str, FedMethodSpec] = {
    "fedavg_full": FedMethodSpec("fedavg_full", "dense", "adamw",
                                 "dense_avg", "none"),
    "fedit": FedMethodSpec("fedit", "lora", "adam", "factor_avg", "none"),
    "ffa_lora": FedMethodSpec("ffa_lora", "lora_b", "sgd", "factor_avg",
                              "none"),
    "lora_fair": FedMethodSpec("lora_fair", "lora", "sgd", "fair", "none"),
    "flora": FedMethodSpec("flora", "lora", "adamw", "lift_merge", "none"),
    "fr_lora": FedMethodSpec("fr_lora", "lora", "adamw", "lift_refac",
                             "none"),
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


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """The reference's ``FedConfig`` fields that mean something in eager
    rounds. The round switches keep the reference's meaning:
    ``fused_round`` and ``factored_sync`` both True select the factored
    𝒮 of the fused round, either False the eager oracle round;
    ``factored_clients`` lets the GaLore methods keep rank-r client state;
    ``lift_free`` (with factored clients) reads target leaves lift-free
    after round 0, False keeps the transient-lift read in every round.
    ``participation`` is the population layer's plan config
    (``core.population.PopulationRunner`` reads it; the engine consumes
    only the per-round masks). ``quarantine`` screens factored uploads
    (non-finite, or norm above ``quarantine_zmax`` × the weighted median)
    and folds failures into the mask path; ``robust_agg`` swaps the
    weighted means of 𝒜 and 𝒮 for 'norm_clip', 'trimmed_mean' (trim
    ``robust_trim`` per tail) or 'geomedian' (at most ``robust_iters``
    Weiszfeld steps, early exit at ``robust_tol``)."""
    method: str = "fedgalore"
    rank: int = 8
    lora_scale: float = 2.0            # alpha / r
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0   # Assumption 3.8 (bounded G)
    local_steps: int = 8               # T
    adaptive_refreshes: int = 2        # S (SVD->random schedule)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    seed: int = 0
    factored_sync: bool = True
    fused_round: bool = True
    factored_clients: bool = True
    lift_free: bool = True
    participation: Optional[ParticipationConfig] = None
    robust_agg: str = "none"
    quarantine: bool = False
    quarantine_zmax: float = 6.0
    robust_trim: float = 0.2
    robust_iters: int = 8
    robust_tol: float = 1e-6


def _check_config(cfg: FedConfig) -> None:
    if cfg.method not in METHODS:
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.robust_agg not in agg.ROBUST_MODES:
        raise ValueError(f"robust_agg={cfg.robust_agg!r} not in "
                         f"{agg.ROBUST_MODES}")


def _check_trainable_model(params: PyTree) -> None:
    """Refuse a model with MLA or Mamba layers (an attention dict holding
    ``kv_b``, or a ``mamba`` dict): their rounds, the lift-free read
    through MLA's ``kv_b`` and Mamba's projections and the reference's
    MLA + ``attn_chunk`` gate on it, are ROADMAP Queue 1 item 11.9."""
    blocks = params.get("blocks", ()) if isinstance(params, dict) else ()
    for block in blocks:
        if "mamba" in block or "kv_b" in block.get("attn", {}):
            raise NotImplementedError(
                "training a model with MLA or Mamba layers is ROADMAP "
                "Queue 1 item 11.9; only its serving path is ported")


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


def merge_lora(base: PyTree, adapters: PyTree, scale: float,
               freeze_a: bool = False) -> PyTree:
    """``W0 + (scale·B A)`` cast to W0's dtype per adapted leaf;
    ``freeze_a`` stops A's gradient (FFA-LoRA)."""
    if freeze_a:
        adapters = tree.tree_map(
            lambda ad: ad if ad is None else ad._replace(a=ad.a.detach()),
            adapters,
            is_leaf=lambda x: x is None or lora_lib.is_lora_pair(x))
    return lora_lib.apply_lora(base, adapters, scale)


def _to_device(batch: PyTree, device) -> PyTree:
    """Any tree of arrays (a dict of fields, a tuple (x, y), ...) as
    tensors on ``device``."""
    return tree.tree_map(
        lambda v: torch.as_tensor(v if torch.is_tensor(v) else np.array(v),
                                  device=device), batch)


def _index(batches: PyTree, i: int) -> PyTree:
    return tree.tree_map(lambda v: v[i], batches)


# -------------------------------------------------------------- the engine --

class FedEngine:
    """Federated simulation of every method of :data:`METHODS`.
    ``loss_fn(params, batch) -> scalar tensor``; ``params`` sit on the
    device the rounds run on."""

    def __init__(self, cfg: FedConfig, loss_fn: Callable, params: PyTree,
                 target_fn: Callable = None, eval_fn: Callable = None):
        _check_config(cfg)
        _check_trainable_model(params)
        self.cfg = cfg
        self.spec = METHODS[cfg.method]
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.target_fn = target_fn or (lambda p, x: True)
        leaves = tree.tree_leaves(params)
        self.device = leaves[0].device if leaves else torch.device("cpu")
        if self.spec.trainable in ("dense", "galore"):
            self.global_trainable, self.frozen = split_trainable(
                params, self.target_fn)
        else:
            self.global_trainable = lora_lib.tree_lora_init(
                prng.PRNGKey(cfg.seed, device=self.device), params,
                self.target_fn, cfg.rank)
            self.frozen = params   # LoRA: base stays whole, delta additive
        if not tree.tree_leaves(self.global_trainable):
            raise ValueError(
                f"target_fn selected no trainable leaves for method "
                f"'{cfg.method}' — nothing to train or aggregate")
        self.galore_cfg = gal.GaloreConfig(
            rank=cfg.rank, refresh_every=10 ** 9,   # engine refreshes itself
            adaptive_steps=cfg.adaptive_refreshes, b1=cfg.b1, b2=cfg.b2,
            eps=cfg.eps, refresh_mode="auto")
        self.tx = self._make_tx()
        # tx.init depends only on the trainables' shapes and the seed, and
        # every update is out of place, so the fresh state every InitState
        # starts from is built once.
        self._fresh_opt = self.tx.init(self.global_trainable)
        # Factored-delta clients: GaLore methods whose trainable is
        # entirely target blocks carry rank-r accumulators instead of
        # dense per-client weight copies.
        self._factored = bool(
            cfg.factored_clients and self.spec.optimizer == "galore_adamw"
            and gal.all_blocks_projected(gal.galore_state_of(
                self._fresh_opt)))
        self._lift_free = bool(cfg.lift_free) and self._factored
        self._guard_cfg = bool(cfg.quarantine) or cfg.robust_agg != "none"
        if self._guard_cfg and not self._factored:
            raise ValueError(
                "quarantine/robust_agg need the factored client model "
                "(GaLore methods with factored_clients=True) — the screen "
                "and the robust reductions run on rank-r factored stacks")
        self.round_idx = 0
        self.synced_v = None        # projected ṽ init from 𝒮
        # The last round's retained client buffers: (C, ·) factored
        # accumulators or dense trainables, and the optimizer states. A
        # dense-client round keeps its stacked trainables (and GaLore
        # states) only with ``retain_clients``, which the population
        # layer sets for its harvest.
        self._client_state = None
        self._client_opt = None
        self.retain_clients = False
        self.quarantined = None     # (C,) bool: the last guard's verdict

    # ----------------------------------------------------------- optimizer --
    def _make_tx(self):
        c = self.cfg
        o = self.spec.optimizer
        if o == "sgd":
            return optim_lib.sgd(c.lr, clip_norm=c.clip_norm)
        if o == "sgdm":
            return optim_lib.sgd(c.lr, momentum=0.9, clip_norm=c.clip_norm)
        if o == "adam":
            return optim_lib.adam(c.lr, c.b1, c.b2, c.eps,
                                  clip_norm=c.clip_norm)
        if o == "adamw":
            return optim_lib.adamw(c.lr, c.b1, c.b2, c.eps, c.weight_decay,
                                   clip_norm=c.clip_norm)
        if o == "galore_adamw":
            return gal.galore_adamw(self.galore_cfg, c.lr, c.weight_decay,
                                    seed=c.seed, clip_norm=c.clip_norm)
        raise ValueError(o)

    # -------------------------------------------------------------- 𝒯 -------
    def _trainable_loss(self, trainable, batch):
        if self.spec.trainable in ("dense", "galore"):
            params = merge_dense(self.frozen, trainable)
        else:
            params = merge_lora(self.frozen, trainable, self.cfg.lora_scale,
                                freeze_a=(self.spec.trainable == "lora_b"))
        return self.loss_fn(params, batch)

    def _init_state0(self, round_idx: int, synced_v):
        """The round-start InitState (Eq. 5), identical for every client:
        fresh moments and, for GaLore, the synced ṽ installed and the
        seeded refresh for round ``round_idx``."""
        st = self._fresh_opt
        if self.spec.optimizer != "galore_adamw":
            return st
        g = gal.galore_state_of(st)
        g = gal.with_seed(g, self.cfg.seed + round_idx)          # s_k
        g = g._replace(count=round_idx * self.cfg.local_steps)
        if synced_v is not None:
            g = gal.with_projected_v(g, synced_v)
        g = gal.manual_refresh(self.galore_cfg, g, round_idx)
        return gal.replace_galore_state(st, g)

    def _local_train_one(self, trainable, opt_state, batches):
        """T local steps of one client on its own dense trainables
        (Definition 3.1): autograd of the merged loss, ``tx.update``,
        ``apply_updates``. A leaf the loss does not reach (FFA-LoRA's
        frozen A) gets a zero gradient, as under ``stop_gradient``.
        Returns (trainable, opt_state, losses (T,))."""
        losses = []
        for t in range(self.cfg.local_steps):
            leaves, tdef = tree.tree_flatten(trainable)
            leaves = [x.detach().requires_grad_(True) for x in leaves]
            loss = self._trainable_loss(tdef.unflatten(leaves),
                                        _index(batches, t))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = tdef.unflatten([torch.zeros_like(x) if g is None else g
                                    for g, x in zip(grads, leaves)])
            with torch.no_grad():
                updates, opt_state = self.tx.update(grads, opt_state,
                                                    trainable)
                trainable = optim_lib.apply_updates(trainable, updates)
            losses.append(loss.detach().float())
        return trainable, opt_state, torch.stack(losses)

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
            batch = _index(batches, t)
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
    def _normalize_weights(self, weights, k_clients):
        return sync_lib.normalize_weights(weights, k_clients,
                                          device=self.device)

    def _masked_weights(self, weights, mask, k_clients):
        """A masked round's weights: the base weights with masked-out
        clients zeroed, renormalized over the participants on the host,
        as the reference does."""
        w = self._normalize_weights(weights, k_clients).cpu().numpy()
        wm = np.where(np.asarray(mask, bool), w, 0.0)
        s = float(wm.sum())
        if s <= 0.0:
            raise ValueError("participation mask drops every client in the "
                             "cohort — a round needs >= 1 on-time participant")
        return torch.as_tensor(wm / s, dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _canon_mask(mask, k_clients):
        """None or an all-true mask is None: full participation takes the
        unmasked path."""
        if mask is None:
            return None
        m = np.asarray(mask, bool).reshape(-1)
        if m.shape != (k_clients,):
            raise ValueError(f"mask shape {m.shape} != cohort ({k_clients},)")
        return None if m.all() else m

    @staticmethod
    def _canon_attack(attack, k_clients):
        """None or an all-ones attack is None: an adversary-free round
        never takes the guarded path on its own."""
        if attack is None:
            return None
        a = np.asarray(attack, np.float32).reshape(-1)
        if a.shape != (k_clients,):
            raise ValueError(f"attack shape {a.shape} != cohort "
                             f"({k_clients},)")
        return None if np.all(a == 1.0) else a

    def run_round(self, client_batches: PyTree, weights=None, mask=None,
                  attack=None):
        """client_batches: a tree of arrays with leading (K clients, T
        steps, ...) axes. Returns ``{"local_loss": (K, T) tensor,
        "mean_final_loss": float}`` and advances the engine's global
        state. ``fused_round=False`` or ``factored_sync=False`` runs the
        eager oracle round.

        ``mask`` (bool (K,)) marks the on-time participants: masked-out
        clients keep their slot and train, but carry zero weight in 𝒜 and
        are excluded from the AJIVE joint basis in 𝒮 (the eager round
        masks the weights only). ``attack`` (float (K,)) multiplies each
        client's factored uplink after the local phase (NaN corrupted
        shard, -1 sign flip, s norm scale). Any attack, or a
        ``quarantine`` / ``robust_agg`` config, takes the guarded round;
        a full mask and an all-ones attack are no mask and no attack."""
        batches = _to_device(client_batches, self.device)
        k_clients = tree.tree_leaves(batches)[0].shape[0]
        mask = self._canon_mask(mask, k_clients)
        attack = self._canon_attack(attack, k_clients)
        guarded = self._guard_cfg or attack is not None
        w = (self._normalize_weights(weights, k_clients) if mask is None
             else self._masked_weights(weights, mask, k_clients))
        eager = not (self.cfg.fused_round and self.cfg.factored_sync)
        if guarded and eager:
            raise ValueError(
                "quarantine/robust_agg/attack injection require the "
                "fused factored round (fused_round + factored_sync)")
        if guarded and not self._factored:
            raise ValueError("the guarded round requires factored clients")
        self.quarantined = None
        exclude_zero = guarded or mask is not None
        if self._factored and not eager:
            losses = self._run_round_factored(batches, w, k_clients,
                                              exclude_zero, guarded, attack)
        else:
            losses = self._run_round_dense(batches, w, k_clients, eager,
                                           exclude_zero)
        self.round_idx += 1
        return {"local_loss": losses,                      # (K, T)
                "mean_final_loss": float(losses[:, -1].mean())}

    def _run_round_factored(self, batches, w, k_clients,
                            exclude_zero: bool = False,
                            guarded: bool = False, attack=None):
        round_idx = self.round_idx
        st0 = self._init_state0(round_idx, self.synced_v)
        transient = not self._lift_free or (
            round_idx == 0 and self._round0_adaptive())
        outs = [self._local_train(st0, _index(batches, c), transient)
                for c in range(k_clients)]
        out_d = tree.tree_map(lambda *xs: torch.stack(xs),
                              *[o[0] for o in outs])
        out_opt = gal.stack_opt_states([o[1] for o in outs])
        losses = torch.stack([o[2] for o in outs])
        scales = torch.stack([o[3] for o in outs])
        del outs
        robust = "none"
        if guarded:
            out_d, out_opt, scales, w = self._apply_guard(out_d, out_opt,
                                                          scales, w, attack)
            robust = self.cfg.robust_agg
        self.global_trainable = self._aggregate_factored(
            self.global_trainable, out_d, out_opt, scales, w, round_idx,
            robust)
        if self._method_syncs():
            self.synced_v = self._sync_states(out_opt, w, round_idx,
                                              exclude_zero, robust)
        self._client_state, self._client_opt = out_d, out_opt
        return losses

    @torch.no_grad()
    def _apply_guard(self, out_d, out_opt, scales, w, attack):
        """The defense gate between the local phase and 𝒜/𝒮.

        1. Each client's uplink (accumulators and projected moments) is
           multiplied by its ``attack`` entry.
        2. With ``quarantine``, the screen
           (``aggregation.screen_factored_clients``) folds failing clients
           into the mask path: weights zeroed and renormalized, stacks and
           scales sanitized by selection (0·NaN never reaches a
           reduction), moments zeroed out of the AJIVE score Gram. An
           all-pass verdict leaves every operand bitwise as it was.

        Returns (out_d, out_opt, scales, w) and sets ``self.quarantined``.
        """
        tmap = tree.tree_map
        g = gal.galore_state_of(out_opt)
        v_tree = gal.extract_projected_v(g)
        if attack is not None:
            a = torch.as_tensor(attack, dtype=torch.float32,
                                device=self.device)

            def hit(x):
                if x is None:
                    return None
                ab = a.reshape((-1,) + (1,) * (x.ndim - 1))
                return (x.float() * ab).to(x.dtype)

            out_d = tmap(hit, out_d)
            v_tree = tmap(hit, v_tree, is_leaf=lambda x: x is None)
        if self.cfg.quarantine:
            keep = agg.screen_factored_clients(
                out_d, v_tree, scales, w, zmax=self.cfg.quarantine_zmax)
            out_d = agg.mask_client_rows(out_d, keep)
            v_tree = agg.mask_client_rows(v_tree, keep)
            scales = torch.where(keep, scales, 1.0)   # enters the sbar sum
            w = agg.quarantine_weights(w, keep)
            self.quarantined = ~keep
        out_opt = gal.replace_galore_state(out_opt,
                                           gal.with_projected_v(g, v_tree))
        return out_d, out_opt, scales, w

    def _run_round_dense(self, batches, w, k_clients, eager: bool,
                         exclude_zero: bool = False):
        """Dense clients one after another from the round's InitState,
        then 𝒜 on the stacked trainables and 𝒮 (eager or factored;
        ``exclude_zero`` drops zero-weight clients from the AJIVE joint
        basis). With ``retain_clients`` the fused round keeps the stacked
        trainables and, for GaLore methods, the stacked optimizer states
        for the population layer's harvest; otherwise only what 𝒮 reads.
        The last round's buffers are released before this one trains."""
        round_idx = self.round_idx
        st0 = self._init_state0(round_idx, self.synced_v)
        syncs = self._method_syncs()
        retain = self.retain_clients and not eager
        keep_opt = syncs or (retain
                             and self.spec.optimizer == "galore_adamw")
        self._client_state = self._client_opt = None
        trainables, opts, losses = [], [], []
        for c in range(k_clients):
            tr, st, loss = self._local_train_one(self.global_trainable, st0,
                                                 _index(batches, c))
            trainables.append(tr)
            losses.append(loss)
            opts.append(st if keep_opt else None)
            del tr, st
        stacked = tree.tree_map(lambda *xs: torch.stack(xs), *trainables)
        del trainables
        self.global_trainable, self.frozen = self._aggregate_pure(
            stacked, w, self.frozen, round_idx)
        self._client_state = stacked if retain else None
        del stacked
        self._client_opt = gal.stack_opt_states(opts) if keep_opt else None
        if syncs:
            self.synced_v = (
                self._sync_states_eager(self._client_opt, w, round_idx)
                if eager else
                self._sync_states(self._client_opt, w, round_idx,
                                  exclude_zero))
        return torch.stack(losses)

    def run_rounds(self, round_batches: PyTree, weights=None, masks=None):
        """K rounds in order: round_batches has leading (K rounds, C
        clients, T steps, ...) axes; ``masks`` (bool (K, C)) one
        participation mask per round. Returns ``local_loss`` (K, C, T)."""
        k_rounds, k_clients = tree.tree_leaves(round_batches)[0].shape[:2]
        if masks is not None:
            masks = np.asarray(masks, bool)
            if masks.shape != (int(k_rounds), int(k_clients)):
                raise ValueError(f"masks shape {masks.shape} != "
                                 f"({k_rounds}, {k_clients})")
        losses = torch.stack([
            self.run_round(_index(round_batches, r), weights,
                           None if masks is None else masks[r])["local_loss"]
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
                            base_scales, w, round_idx, robust: str = "none"):
        """𝒜 for factored clients: ``(Σᵢ wᵢ sᵢ)·W + Σᵢ wᵢ lift(Rᵢ, Bᵢ)`` per
        target leaf; ``robust`` swaps the weighted mean over the factored
        stacks for a robust reduction ('none' is exactly the plain
        path)."""
        bases = gal.extract_bases(gal.galore_state_of(out_opt))
        hetero = self._round0_hetero(round_idx)
        sbar = torch.einsum("c,c->", w, base_scales.float())
        c = self.cfg

        def one(w0, d_stack, b_stack):
            side = (proj.RIGHT if d_stack.shape[-1] == b_stack.shape[-1]
                    else proj.LEFT)
            lifted = agg.robust_factored_lift(
                d_stack, b_stack, side, w, robust, hetero=hetero,
                trim=c.robust_trim, iters=c.robust_iters, tol=c.robust_tol)
            return (sbar * w0.float() + lifted).to(w0.dtype)

        return tree.tree_map(one, global_trainable, out_deltas, bases)

    @torch.no_grad()
    def _aggregate_pure(self, stacked, w, frozen, round_idx):
        """𝒜 on the client-stacked trainables: returns
        (new_global_trainable, new_frozen)."""
        s = self.spec.aggregation
        c = self.cfg
        if s == "dense_avg":
            return agg.dense_delta_average(stacked, w), frozen
        if s == "factor_avg":
            return agg.factor_average(stacked, w), frozen
        if s == "fair":
            return agg.lora_fair_refine(stacked, w, c.lora_scale), frozen
        if s not in ("lift_merge", "lift_refac"):
            raise ValueError(s)
        deltas = agg.lift_average(stacked, w, c.lora_scale)
        is_none = lambda x: x is None  # noqa: E731
        if s == "lift_merge":
            # FLoRA: the full-rank average reaches every client through the
            # merged base; adapters restart from a fresh draw.
            frozen = tree.tree_map(
                lambda p, d: p if d is None else p + d.to(p.dtype),
                frozen, deltas, is_leaf=is_none)
            return self._fresh_adapters(round_idx), frozen
        # FR-LoRA: the rank-r refactorization carries what fits in the
        # adapters; the residual merges into the base (kept, not lost).
        dl, treedef = tree.tree_flatten(deltas, is_leaf=is_none)
        new_ad, resid = [], []
        for d in dl:
            if d is None:
                new_ad.append(None)
                resid.append(None)
                continue
            pair = lora_lib.svd_truncate(d / max(c.lora_scale, 1e-12),
                                         c.rank)
            new_ad.append(pair)
            resid.append(d - c.lora_scale * (pair.b @ pair.a))
        resid = treedef.unflatten(resid)
        frozen = tree.tree_map(
            lambda p, r: p if r is None else p + r.to(p.dtype),
            frozen, resid, is_leaf=is_none)
        return treedef.unflatten(new_ad), frozen

    def _fresh_adapters(self, round_idx: int):
        key = prng.PRNGKey(self.cfg.seed + 1000 + round_idx,
                           device=self.device)
        return lora_lib.tree_lora_init(key, self.frozen, self.target_fn,
                                       self.cfg.rank)

    # -------------------------------------------------------------- 𝒮 -------
    def _method_syncs(self) -> bool:
        return (self.spec.state_sync != "none"
                and self.spec.optimizer == "galore_adamw")

    def _uplink(self, stacked_opt):
        """Per-leaf lists of the client-stacked projected ṽ (K, ., r) and
        bases (K, dim, r), and the ṽ tree's structure."""
        g_stack = gal.galore_state_of(stacked_opt)
        is_none = lambda x: x is None  # noqa: E731
        vs, treedef = tree.tree_flatten(gal.extract_projected_v(g_stack),
                                        is_leaf=is_none)
        bs = tree.tree_leaves(gal.extract_bases(g_stack), is_leaf=is_none)
        return vs, bs, treedef

    @staticmethod
    def _side(v_stack, b_stack):
        rank = b_stack.shape[-1]
        return rank, proj.RIGHT if v_stack.shape[-1] == rank else proj.LEFT

    @torch.no_grad()
    def _sync_states(self, stacked_opt, w, round_idx,
                     exclude_zero: bool = False, robust: str = "none"):
        """Factored 𝒮: shared-basis rounds sync on the projected ṽ
        directly; the adaptive round 0 runs the heterogeneous-basis sync
        (r×r transfer Grams). One batched program per shape bucket.
        ``exclude_zero`` (masked and guarded rounds) drops zero-weight
        clients from the AJIVE joint basis; ``robust`` robustifies the
        reductions over the moment stacks."""
        protocol = self.spec.state_sync
        hetero = self._round0_hetero(round_idx)
        c = self.cfg
        kw = dict(exclude_zero_weights=exclude_zero, robust=robust,
                  trim=c.robust_trim, iters=c.robust_iters, tol=c.robust_tol)

        def leaf_fn(v_stack, b_stack, n_batch):
            rank, side = self._side(v_stack, b_stack)
            if hetero:
                return sync_lib.sync_block_hetero_factored(
                    protocol, v_stack, b_stack, side, w, rank, **kw)
            return sync_lib.sync_block_synced_factored(
                protocol, v_stack, side, w, rank, batch_dims=n_batch, **kw)

        vs, bs, treedef = self._uplink(stacked_opt)
        return treedef.unflatten(sync_lib.map_sync_leaves(leaf_fn, vs, bs))

    @torch.no_grad()
    def _sync_states_eager(self, stacked_opt, w, round_idx):
        """The eager oracle's 𝒮, leaf by leaf: the factored shared-basis
        path when ``factored_sync`` holds and bases are shared, otherwise
        (the adaptive round 0, or ``factored_sync=False``) each client's ṽ
        lifted with its own basis, synchronized densely and re-projected
        onto client 0's end-of-round basis; stacked scan blocks (K, nb,
        ., r) sync as one batch, as under the reference's vmap."""
        protocol = self.spec.state_sync
        use_factored = (self.cfg.factored_sync
                        and not self._round0_hetero(round_idx))

        def sync_block(v_stack, b_stack):
            rank, side = self._side(v_stack, b_stack)
            if use_factored:
                return sync_lib.sync_block_synced_factored(
                    protocol, v_stack, side, w, rank)
            v32, b32 = v_stack.float(), b_stack.float()
            if side == proj.RIGHT:
                views = torch.einsum("k...mr,k...nr->k...mn", v32, b32)
            else:
                views = torch.einsum("k...mr,k...rn->k...mn", b32, v32)
            lifted = sync_lib.sync_lifted_views(protocol, views, w, rank)
            return sync_lib.project_state(lifted, b_stack[0], side)

        vs, bs, treedef = self._uplink(stacked_opt)
        return treedef.unflatten([None if v is None else sync_block(v, b)
                                  for v, b in zip(vs, bs)])

    # ------------------------------------------------------------- helpers --
    def _frozen_mutates(self) -> bool:
        """Only the lift aggregations (FLoRA / FR-LoRA) write the frozen
        base."""
        return self.spec.aggregation in ("lift_merge", "lift_refac")

    def _zero_synced_template(self):
        """Zeros shaped like the synced ṽ tree."""
        return tree.tree_map(
            lambda x: None if x is None else torch.zeros_like(x),
            gal.extract_projected_v(gal.galore_state_of(self._fresh_opt)),
            is_leaf=lambda x: x is None)

    def _ensure_client_buffers(self, k_clients: int):
        """Allocate the retained client buffers before any round has (a
        snapshot or restore of a fresh engine needs their layout): zeros
        shaped like a round's outputs — factored (C, ·, r) accumulators or
        dense (C, ·) trainables, and the stacked optimizer states."""
        have = (self._client_state is not None
                and tree.tree_leaves(self._client_state)[0].shape[0]
                == k_clients)
        if have:
            return
        st = gal.stack_opt_states([self._init_state0(0, None)] * k_clients)
        self._client_opt = tree.tree_map(
            lambda x: torch.zeros_like(x) if torch.is_tensor(x) else x, st)
        if self._factored:
            self._client_state = gal.zero_client_deltas(
                gal.galore_state_of(self._client_opt))
        else:
            self._client_state = tree.tree_map(
                lambda x: torch.zeros((k_clients,) + tuple(x.shape),
                                      dtype=x.dtype, device=x.device),
                self.global_trainable)

    def global_params(self) -> PyTree:
        if self.spec.trainable in ("dense", "galore"):
            return merge_dense(self.frozen, self.global_trainable)
        with torch.no_grad():
            return merge_lora(self.frozen, self.global_trainable,
                              self.cfg.lora_scale)

    @torch.no_grad()
    def evaluate(self, batch) -> float:
        batch = _to_device(batch, self.device)
        fn = self.eval_fn or self.loss_fn
        return float(fn(self.global_params(), batch))
