"""The federated runtime: the paper's round on a device mesh (port of
``repro/fedsim/runtime.py``).

One :meth:`ShardedFederation.run_round` call runs the **whole round**:
T local GaLoreAdamW steps per client, factored aggregation 𝒜 over the
clients and the server-side state filter 𝒮 (Algorithm 1, line 12) —
factored sync of the projected second moments, O(dim·r) install, seed
bump (``launch.steps.make_fed_round_step``). The clients' optimizer
states persist across rounds, stacked (C, …) with the GaLore count and
seed as host ints (``core.galore.stack_opt_state``).

Client memory model: with the default ``factored_clients=True`` a
client's round state is the rank-r factored accumulator ``R_i`` around the
shared global base, and with the default ``lift_free=True`` the local
step is lift-free (``models.layers.LowRankDelta`` leaves through
``kernels.ops.lowrank_linear``); ``lift_free=False``, ``refresh_mode=
'svd'`` and MLA with blockwise attention keep the transient-lift read
through the fused preconditioner. ``factored_clients=False`` restores the
dense per-client weight copies (the parity oracle, and the required
fallback when ``refresh_every % local_steps != 0``). The server sync runs
factored in every default configuration: on the shared seeded basis, or
via r×r transfer Grams when data-driven refreshes diverge the bases
(``refresh_mode='svd'``). ``factored_sync=False`` restores the dense lift
(the parity oracle), and ``fused_round=False`` the legacy round: 𝒯𝒜,
then 𝒮 as a separate step (:meth:`ShardedFederation._sync_and_reinit`).

The mesh comes from ``launch.mesh.make_host_mesh``, and the runtime runs
on its device. A mesh of more than one device is refused (ROADMAP Queue
1 item 12c): every tensor stays a plain local tensor, not a DTensor, and
the kernels take plain tensors. Clients run one after another, so the
reference's execution knobs that only reschedule the same arithmetic
(``client_chunk``, ``bucketed_sync``, buffer donation) have no
counterpart, and :meth:`ShardedFederation.run_rounds` is a loop of
:meth:`ShardedFederation.run_round`: the reference's one-round-deep
pipelined scan (``pipeline_sync``) is the same arithmetic reassociated,
which its own suite holds equal to this sequential schedule.

This is the production counterpart of ``core.fed.FedEngine``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import fed as fed_lib
from ..core import galore as gal
from ..core import population as pop_lib
from ..core.fed import _to_device
from ..launch import steps as steps_lib
from ..utils import tree

PyTree = Any


def mesh_device(mesh) -> torch.device:
    """The one device of a size-1 mesh; a larger mesh is refused."""
    if mesh.size() != 1:
        raise ValueError(
            f"ShardedFederation runs on a one-device mesh; this mesh has "
            f"{mesh.size()} devices {tuple(mesh.shape)} — multi-device "
            "execution is ROADMAP Queue 1 item 12c, not ported")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class ShardedFederation:
    """``participation`` (a ``core.population.ParticipationConfig``)
    enables the participation layer: :meth:`sample_round_mask` draws the
    seeded per-round fault plan, and :meth:`run_round` / :meth:`run_rounds`
    accept per-round participation masks. Masked rounds run a separately
    built round — the same round math on mask-zeroed weights (the
    normalization renormalizes over the participants) plus AJIVE
    joint-basis exclusion of the masked-out clients — and an all-true
    mask short-circuits onto the unmasked round (bit-identical by
    construction)."""

    def __init__(self, cfg: ArchConfig, spec: steps_lib.TrainSpec, mesh,
                 n_clients: int, state_sync: str = "ajive", seed: int = 0,
                 factored_sync: bool = True, fused_round: bool = True,
                 factored_clients: bool = True,
                 lift_free: Optional[bool] = None,
                 participation: Optional[
                     pop_lib.ParticipationConfig] = None,
                 robust_agg: str = "none", quarantine: bool = False,
                 quarantine_zmax: float = 6.0, robust_trim: float = 0.2,
                 robust_iters: int = 8, robust_tol: float = 1e-6):
        self.device = mesh_device(mesh)
        self.cfg = cfg
        self.spec = spec
        self.mesh = mesh
        self.n_clients = n_clients
        self.state_sync = state_sync
        self.factored_sync = factored_sync
        self.fused_round = fused_round
        self.participation = participation
        self.quarantine = quarantine
        self.round_idx = 0

        self.global_trainable, self.frozen, opt_state = \
            steps_lib.init_train_state(cfg, spec, seed, self.device)
        # per-client moments/bases stacked on axis 0; count/seed host ints
        self.opt_states = gal.stack_opt_state(opt_state, n_clients,
                                              copy=True)
        # The fused round runs 𝒮 + install + seed bump inside the round;
        # state_sync=None builds the legacy 𝒯𝒜-only round. The defense
        # knobs run inside the round too: quarantine screens the factored
        # uplink and folds failures into the zero-weight mask path;
        # robust_agg swaps the weighted means of 𝒜 and 𝒮 for robust
        # reductions. The (C,) attack operand rides run_round(attack=).
        self._step_kwargs = dict(
            factored_sync=factored_sync, factored_clients=factored_clients,
            lift_free=lift_free, robust_agg=robust_agg,
            quarantine=quarantine, quarantine_zmax=quarantine_zmax,
            robust_trim=robust_trim, robust_iters=robust_iters,
            robust_tol=robust_tol)
        self._robust_sync_kwargs = dict(
            robust_agg=robust_agg, robust_trim=robust_trim,
            robust_iters=robust_iters, robust_tol=robust_tol)
        self._round = steps_lib.make_fed_round_step(
            cfg, spec, n_clients,
            state_sync=(state_sync if fused_round else None),
            **self._step_kwargs)
        # the participation-masked round, built on first use
        self._round_masked = None

    # -------------------------------------------------- participation -------
    def sample_round_mask(self, round_idx: Optional[int] = None
                          ) -> np.ndarray:
        """The seeded on-time participation mask for ``round_idx``
        (default: the next round) under this federation's
        ``participation`` config — a pure host function of (config,
        round)."""
        if self.participation is None:
            return np.ones(self.n_clients, bool)
        r = self.round_idx if round_idx is None else int(round_idx)
        return pop_lib.sample_cohort(self.participation, self.n_clients, r,
                                     self.n_clients).mask

    def _canon_mask(self, mask):
        """``core.fed.canon_mask``; a mask that drops every client is
        refused."""
        m = fed_lib.canon_mask(mask, self.n_clients)
        if m is not None and not m.any():
            raise ValueError("participation mask drops every client — a "
                             "round needs >= 1 on-time participant")
        return m

    def _canon_attack(self, attack):
        """``core.fed.canon_attack``, on the device."""
        a = fed_lib.canon_attack(attack, self.n_clients)
        return None if a is None else torch.as_tensor(a, device=self.device)

    def _masked_round(self):
        if self._round_masked is None:
            self._round_masked = steps_lib.make_fed_round_step(
                self.cfg, self.spec, self.n_clients,
                state_sync=(self.state_sync if self.fused_round else None),
                exclude_zero_weights=True, **self._step_kwargs)
        return self._round_masked

    def _base_weights(self, weights):
        if weights is None:
            return torch.full((self.n_clients,), 1.0 / self.n_clients,
                              dtype=torch.float32, device=self.device)
        return torch.as_tensor(np.asarray(weights, np.float32),
                               device=self.device)

    def run_round(self, batches: PyTree, weights=None, mask=None,
                  attack=None):
        """batches: a tree of arrays with leading (C, T, b, ...) axes.

        ``mask`` (bool (C,)) marks the round's on-time participants:
        masked-out clients keep their slot and train, but get zero
        effective weight (the normalization renormalizes over the
        participants) and leave the AJIVE joint basis. An all-true mask is
        no mask.

        ``attack`` ((C,) float) multiplies each client's factored uplink —
        accumulators and projected moments — after the local phase,
        before the quarantine screen. Attacked rounds run the
        exclusion-aware guarded round; an all-ones attack is no attack.
        Requires the fused round."""
        mask = self._canon_mask(mask)
        attack = self._canon_attack(attack)
        if attack is not None and not self.fused_round:
            raise ValueError("attack injection requires fused_round=True "
                             "(the legacy separate-𝒮 round syncs with "
                             "pre-quarantine weights)")
        batches = _to_device(batches, self.device)
        w = self._base_weights(weights)
        if mask is None and attack is None:
            round_fn = self._round
        else:
            round_fn = self._masked_round()
            if mask is not None:
                w = w * torch.as_tensor(mask, dtype=w.dtype, device=w.device)
        extra = () if attack is None else (attack,)
        new_global, out_states, losses, v_upload = round_fn(
            self.global_trainable, self.frozen, self.opt_states, batches, w,
            *extra)
        self.global_trainable = new_global
        if self.fused_round:
            # 𝒮 already ran; the returned states are next-round-ready
            self.opt_states = out_states
        else:
            # unmasked: the raw weights; masked: renormalized over the
            # participants, the zero-weight clients excluded from 𝒮
            w_sync = w if mask is None else w / torch.sum(w)
            self.opt_states = self._sync_and_reinit(
                out_states, v_upload, w_sync, exclude_zero=mask is not None)
        self.round_idx += 1
        return {"losses": losses,
                "mean_final_loss": float(losses[:, -1].mean())}

    def run_rounds(self, batches: PyTree, weights=None, masks=None):
        """K rounds in order, each a :meth:`run_round`.

        batches: a tree with leading (K rounds, C, T, b, ...) axes.
        ``masks`` (optional bool (K, C)) gives each round its
        participation mask. Requires the fused round, as the reference's
        scan does."""
        if not self.fused_round:
            raise ValueError("run_rounds requires fused_round=True: the "
                             "legacy round returns unsynced states and "
                             "would silently skip 𝒮")
        k_rounds = int(tree.tree_leaves(batches)[0].shape[0])
        masks = fed_lib.round_masks(masks, k_rounds, int(self.n_clients))
        if masks is not None and not masks.any(axis=1).all():
            raise ValueError("a round's participation mask drops every "
                             "client")
        losses = fed_lib.rounds_in_order(
            lambda b, w, m: self.run_round(b, w, mask=m), batches, weights,
            masks, "losses")
        return {"losses": losses,                          # (K, C, T)
                "mean_final_loss": float(losses[-1, :, -1].mean())}

    # --------------------------------------------------- 𝒮 (legacy round) ---
    def _sync_and_reinit(self, out_states, v_upload, w, exclude_zero=False):
        """𝒮 of the legacy round: the same server filter as the tail of
        the fused round (``steps.sync_client_states``), run as a separate
        step after 𝒯𝒜."""
        del v_upload    # sync_client_states re-extracts from the states
        return steps_lib.sync_client_states(
            out_states, w, self.n_clients, self.state_sync,
            factored=self.factored_sync, bases_shared=self._bases_shared(),
            exclude_zero_weights=exclude_zero, **self._robust_sync_kwargs)

    def _bases_shared(self) -> bool:
        """The shared-basis factored sync requires every client on the
        same basis. ``refresh_mode='random'`` (or 'auto' with zero adaptive
        steps) refreshes from the broadcast seed: shared by construction.
        'svd' refreshes from each client's own gradient, so bases diverge
        and the sync takes the heterogeneous factored path."""
        return self.spec.refresh_mode != "svd"
