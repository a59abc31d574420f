"""Cohorts drawn from a large population: fault and adversary plans, the
client-state store, the staleness buffer and the crash-resumable runner
(port of ``repro/core/population.py``).

ParticipationConfig / sample_cohort
    The round's plan as a pure host function of ``(config, round)``: which
    population clients hold the C cohort slots, which drop, which
    straggle (their update lands ``delay`` rounds late) and which upload
    corrupted state (NaN shard / sign flip / norm scale, realized as
    uplink multipliers by :func:`corruption_multipliers`). The draws are
    the reference's, in its order, so both packages plan the same rounds.
ClientStateStore
    Sticky per-client rows (factored accumulator + projected moments) for
    the whole population in host numpy shards; least recently used
    shards spill to a directory through :mod:`repro_torch.checkpoint`,
    whose files the reference's store reads and writes too. A writer
    killed mid-spill leaves the shard's previous spill in place (atomic
    replace); a truncated or non-finite file reads back as cold zeros,
    never NaN.
StalenessBuffer
    FedBuff-style bounded staleness: a straggler's contribution is kept
    on the host and merges at its due round with weight
    ``staleness_decay**delay``; a full buffer evicts the earliest-due
    entry; delay 0 never enters it, so ``max_staleness=0`` is exactly the
    synchronous round.
PopulationRunner
    plan → merge due stale updates → the masked (and guarded) engine
    round → harvest the retained client buffers → buffer stragglers →
    scatter rows → drift record; optional snapshots through the
    checkpoint writer and a loss/drift tripwire that rolls the round back
    and replays it without the offending clients.

The stale merge runs on the engine's device in float64, with the
reference's formula and entry order.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import galore as gal
from . import projector as proj
from ..checkpoint import io as ckpt_io
from ..utils import tree

PyTree = Any
_is_none = lambda x: x is None  # noqa: E731


# ------------------------------------------------------------ fault plans ---

@dataclasses.dataclass(frozen=True)
class ParticipationConfig:
    """Seeded cohort sampling and fault injection (the reference's knobs).

    population       virtual population size M (0 ⇒ M = C: every client
                     holds a permanent slot, only faults remain).
    dropout_rate     P(a sampled client drops this round).
    straggler_rate   P(a surviving client straggles).
    max_staleness    straggler delays are uniform on {1..k}; 0 disables
                     straggling (bit-exactly synchronous).
    staleness_decay  β: a delay-d stale update merges with weight β^d.
    stale_scale      server-side learning rate on the stale merge.
    seed             fault-injection seed, independent of the train seed.
    corrupt_rate     P(an on-time client uploads corrupted state), drawn
                     after the fault draws; every plan keeps ≥ 1 honest
                     on-time client (``corrupt_rate >= 1`` raises).
    corrupt_modes    attacks drawn uniformly per corrupted client: 'nan',
                     'sign_flip', 'scale'.
    attack_scale     multiplier of the 'scale' attack.
    """
    population: int = 0
    dropout_rate: float = 0.0
    straggler_rate: float = 0.0
    max_staleness: int = 0
    staleness_decay: float = 0.5
    stale_scale: float = 1.0
    seed: int = 0
    corrupt_rate: float = 0.0
    corrupt_modes: tuple = ("nan", "sign_flip", "scale")
    attack_scale: float = 100.0


CORRUPT_MODES = ("nan", "sign_flip", "scale")


class CohortPlan(NamedTuple):
    """One round's plan (host numpy). ``mask`` True = on-time; ``delays``
    0 on-time, d ≥ 1 straggler, -1 dropped; ``corrupt`` 0 honest, j ≥ 1
    the 1-based index into ``corrupt_modes`` (None: all honest)."""
    round_idx: int
    clients: np.ndarray
    mask: np.ndarray
    delays: np.ndarray
    corrupt: Optional[np.ndarray] = None


def sample_cohort(pcfg: ParticipationConfig, cohort: int, round_idx: int,
                  population: Optional[int] = None) -> CohortPlan:
    """The round's cohort and fault plan, deterministic in ``(pcfg.seed,
    round_idx)`` only. Draw order: sample → dropout → straggle → delays →
    corruption, then the on-time promotion and the honest pardon."""
    pop = population if population is not None else (pcfg.population or cohort)
    if pop < cohort:
        raise ValueError(f"population {pop} < cohort {cohort}")
    rng = np.random.default_rng([pcfg.seed, round_idx])
    if pop == cohort:
        ids = np.arange(cohort, dtype=np.int64)
    else:
        ids = np.sort(rng.choice(pop, size=cohort,
                                 replace=False)).astype(np.int64)
    drop_u = rng.random(cohort)
    strag_u = rng.random(cohort)
    dropped = drop_u < pcfg.dropout_rate
    straggling = (~dropped) & (strag_u < pcfg.straggler_rate)
    if pcfg.max_staleness <= 0:
        straggling[:] = False          # delay-0 ≡ on-time: no buffering
    delays = np.zeros(cohort, dtype=np.int64)
    delays[dropped] = -1
    if straggling.any():
        delays[straggling] = rng.integers(1, pcfg.max_staleness + 1,
                                          size=int(straggling.sum()))
    if not (delays == 0).any():
        delays[0] = 0                  # a round needs ≥ 1 on-time client
    mask = delays == 0
    corrupt = np.zeros(cohort, dtype=np.int64)
    if pcfg.corrupt_rate > 0.0:
        for m in pcfg.corrupt_modes:
            if m not in CORRUPT_MODES:
                raise ValueError(f"corrupt mode {m!r} not in "
                                 f"{CORRUPT_MODES}")
        if not pcfg.corrupt_modes:
            raise ValueError("corrupt_rate > 0 needs >= 1 corrupt mode")
        corrupt_u = rng.random(cohort)
        bad = mask & (corrupt_u < pcfg.corrupt_rate)
        if bad.any():
            corrupt[bad] = rng.integers(1, len(pcfg.corrupt_modes) + 1,
                                        size=int(bad.sum()))
        if not (mask & (corrupt == 0)).any():
            if pcfg.corrupt_rate >= 1.0:
                raise ValueError(
                    "corrupt_rate >= 1 leaves no honest on-time "
                    "participant in any round — quarantine + dropout must "
                    "leave at least one trustworthy client")
            corrupt[int(np.nonzero(mask)[0][0])] = 0
    return CohortPlan(round_idx=int(round_idx), clients=ids, mask=mask,
                      delays=delays, corrupt=corrupt)


def corruption_multipliers(plan: CohortPlan,
                           pcfg: ParticipationConfig) -> Optional[np.ndarray]:
    """A plan's adversaries as (C,) float32 uplink multipliers: 1.0
    honest, NaN corrupted shard, -1.0 sign flip, ``attack_scale`` norm
    attack; None when the plan has no adversary."""
    if plan.corrupt is None or not (plan.corrupt != 0).any():
        return None
    value = {"nan": np.float32(np.nan), "sign_flip": np.float32(-1.0),
             "scale": np.float32(pcfg.attack_scale)}
    mult = np.ones(plan.corrupt.shape[0], np.float32)
    for i in np.nonzero(plan.corrupt)[0]:
        mult[i] = value[pcfg.corrupt_modes[int(plan.corrupt[i]) - 1]]
    return mult


def corruption_schedule(pcfg: ParticipationConfig, cohort: int,
                        rounds: int, start_round: int = 0,
                        population: Optional[int] = None) -> list:
    """One :func:`corruption_multipliers` entry per round (None for honest
    rounds), from the same (seed, round) plans."""
    return [corruption_multipliers(
                sample_cohort(pcfg, cohort, start_round + k, population),
                pcfg)
            for k in range(int(rounds))]


# ------------------------------------------------------ client-state store --

class ClientStateStore:
    """Host-side sticky state for a virtual client population.

    Rows live in per-shard numpy arrays (``shard_size`` clients a shard);
    with a ``directory``, the least recently used shards beyond
    ``max_resident_shards`` spill there through the atomic checkpoint
    writer (files ``clients_{shard:08d}.npz``) and reload on demand. A
    client never scattered reads back as zeros (cold).

    ``template`` is a tree of per-client leaves (no client axis);
    gather/scatter speak (len(ids), ·) stacked trees of its structure.
    """

    def __init__(self, n_clients: int, template: PyTree,
                 directory: Optional[str] = None, shard_size: int = 1024,
                 max_resident_shards: Optional[int] = None):
        self.n_clients = int(n_clients)
        self.shard_size = int(shard_size)
        self.directory = directory
        self.n_shards = -(-self.n_clients // self.shard_size)
        if max_resident_shards is None:
            max_resident_shards = 64 if directory else self.n_shards
        if directory is None and max_resident_shards < self.n_shards:
            raise ValueError("spill requires a directory: "
                             f"{self.n_shards} shards > resident cap "
                             f"{max_resident_shards}")
        self.max_resident = max(1, int(max_resident_shards))
        leaves, self._treedef = tree.tree_flatten(template)
        self._specs = [(tuple(np.shape(x)), np.dtype(np.asarray(x).dtype))
                       for x in leaves]
        self._resident: "OrderedDict[int, list]" = OrderedDict()
        self._dirty: set = set()
        self.last_round = np.full(self.n_clients, -1, dtype=np.int64)
        self.spills = 0
        self.loads = 0

    # -- shard management --
    def _shard_rows(self, shard: int) -> int:
        return min(self.shard_size, self.n_clients - shard * self.shard_size)

    def _zero_shard(self, shard: int) -> list:
        rows = self._shard_rows(shard)
        return [np.zeros((rows,) + shape, dtype)
                for shape, dtype in self._specs]

    def _ensure_resident(self, shard: int) -> list:
        if shard in self._resident:
            self._resident.move_to_end(shard)
            return self._resident[shard]
        data = None
        if self.directory is not None:
            try:
                data = ckpt_io.restore(self.directory, shard,
                                       self._zero_shard(shard),
                                       name="clients")
                self.loads += 1
            except (FileNotFoundError, ValueError):
                # Never spilled, cut short mid-write, or non-finite: the
                # atomic writer leaves nothing half-written under the final
                # name, so each of these cleanly means "cold".
                data = None
        if data is None:
            data = self._zero_shard(shard)
        self._resident[shard] = data
        self._evict()
        return data

    def _evict(self):
        while len(self._resident) > self.max_resident:
            shard, data = self._resident.popitem(last=False)
            if shard in self._dirty:
                self._spill(shard, data)

    def _spill(self, shard: int, data: list):
        if self.directory is None:
            raise RuntimeError("eviction without a spill directory")
        ckpt_io.save(self.directory, shard, data, name="clients")
        self._dirty.discard(shard)
        self.spills += 1

    def flush(self):
        """Spill every dirty resident shard (atomic per shard)."""
        if self.directory is None:
            return
        for shard in sorted(self._dirty & set(self._resident)):
            self._spill(shard, self._resident[shard])

    # -- row access --
    def gather(self, ids: np.ndarray) -> PyTree:
        """Rows for ``ids`` as a stacked (len(ids), ·) tree (zeros for
        cold clients)."""
        ids = np.asarray(ids, np.int64)
        outs = [np.empty((len(ids),) + shape, dtype)
                for shape, dtype in self._specs]
        shards = ids // self.shard_size
        for shard in np.unique(shards):
            sel = np.nonzero(shards == shard)[0]
            rows = ids[sel] - shard * self.shard_size
            data = self._ensure_resident(int(shard))
            for o, d in zip(outs, data):
                o[sel] = d[rows]
        return self._treedef.unflatten(outs)

    def scatter(self, ids: np.ndarray, rows: PyTree,
                round_idx: Optional[int] = None):
        """Write stacked rows back under population ids (the shards turn
        dirty and spill on eviction or ``flush``)."""
        ids = np.asarray(ids, np.int64)
        leaves = tree.tree_leaves(rows)
        if len(leaves) != len(self._specs):
            raise ValueError("scatter tree structure != store template")
        leaves = [_host(x) for x in leaves]
        shards = ids // self.shard_size
        for shard in np.unique(shards):
            sel = np.nonzero(shards == shard)[0]
            rel = ids[sel] - shard * self.shard_size
            data = self._ensure_resident(int(shard))
            for d, leaf in zip(data, leaves):
                d[rel] = leaf[sel]
            self._dirty.add(int(shard))
        if round_idx is not None:
            self.last_round[ids] = int(round_idx)

    def resident_bytes(self) -> int:
        return sum(a.nbytes for data in self._resident.values() for a in data)


def _host(x) -> np.ndarray:
    """A tensor or array as host numpy (bf16 as fp32, which numpy has)."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------- staleness buffer ---

class StaleEntry(NamedTuple):
    """One straggler's buffered contribution (host numpy trees): ``deltas``
    the rank-r accumulator rows (factored clients) or dense trainable
    deltas against the birth-round global; ``bases`` the (dim, r)
    birth-round bases (None for dense); ``v_rows`` the projected moments
    (None for non-GaLore methods)."""
    client_id: int
    birth_round: int
    due_round: int
    weight: float          # cohort sample weight at birth
    decay: float           # staleness_decay**delay * stale_scale
    base_scale: float      # (1-ηλ)^T at birth
    deltas: PyTree
    bases: Optional[PyTree]
    v_rows: Optional[PyTree]


class StalenessBuffer:
    """Entries keyed by due round. ``capacity`` (None = unbounded) caps
    their number: pushing onto a full buffer evicts and drops the entry
    with the earliest due round (FIFO among ties), counted in
    ``evictions``."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = None if capacity is None else int(capacity)
        self._entries: List[StaleEntry] = []
        self.evictions = 0

    def push(self, entry: StaleEntry) -> Optional[StaleEntry]:
        evicted = None
        if (self.capacity is not None
                and len(self._entries) >= self.capacity):
            idx = min(range(len(self._entries)),
                      key=lambda i: (self._entries[i].due_round, i))
            evicted = self._entries.pop(idx)
            self.evictions += 1
        self._entries.append(entry)
        return evicted

    def pop_due(self, round_idx: int) -> List[StaleEntry]:
        due = [e for e in self._entries if e.due_round <= round_idx]
        self._entries = [e for e in self._entries if e.due_round > round_idx]
        return due

    def __len__(self):
        return len(self._entries)

    @property
    def pending_rounds(self) -> List[int]:
        return sorted({e.due_round for e in self._entries})


# ------------------------------------------------------ drift observatory ---

def _f64(x, device=None) -> torch.Tensor:
    """A tensor or array as float64 (on ``device`` when given, else where
    a tensor already lies; arrays go to the CPU)."""
    if torch.is_tensor(x):
        return x.detach().to(device=device or x.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def moment_divergence(v_rows: PyTree, v_bar: PyTree,
                      weights=None) -> float:
    """Weighted relative dispersion of per-client projected moments around
    the synced v̄: sqrt(Σ_i w_i ‖ṽ_i − v̄‖²_F) / (‖v̄‖_F + ε) over the
    adapted blocks, in float64 (tensors stay on their device)."""
    num = den = 0.0
    rows = tree.tree_leaves(v_rows, is_leaf=_is_none)
    bars = tree.tree_leaves(v_bar, is_leaf=_is_none)
    w = None
    for r_leaf, b_leaf in zip(rows, bars):
        if r_leaf is None or b_leaf is None:
            continue
        r64 = _f64(r_leaf)
        b64 = _f64(b_leaf, r64.device)
        if w is None:
            k = r64.shape[0]
            w = (np.full(k, 1.0 / k) if weights is None else
                 np.asarray(weights, np.float64) /
                 max(float(np.sum(weights)), 1e-30))
            w = torch.as_tensor(w, dtype=torch.float64, device=r64.device)
        diff = (r64 - b64[None]).reshape(r64.shape[0], -1)
        num += float(w.to(r64.device) @ torch.sum(diff * diff, dim=1))
        den += float(torch.sum(b64 ** 2))
    return float(np.sqrt(num) / (np.sqrt(den) + 1e-12))


def tree_rel_err(tree_a: PyTree, tree_b: PyTree) -> float:
    """Relative Frobenius error ‖a − b‖_F / (‖b‖_F + ε) over all leaves,
    in float64."""
    num = den = 0.0
    la = tree.tree_leaves(tree_a, is_leaf=_is_none)
    lb = tree.tree_leaves(tree_b, is_leaf=_is_none)
    for a, b in zip(la, lb):
        if a is None or b is None:
            continue
        a64 = _f64(a)
        b64 = _f64(b, a64.device)
        num += float(torch.sum((a64 - b64) ** 2))
        den += float(torch.sum(b64 ** 2))
    return float(np.sqrt(num) / (np.sqrt(den) + 1e-12))


# ------------------------------------------------------------- the runner ---

def _moment_leaf_side(delta_leaf, basis_leaf) -> str:
    """Right buffers (..., m, r) pair an (..., n, r) basis (trailing dims
    agree); left buffers (..., r, n) an (..., m, r) one."""
    return (proj.RIGHT if delta_leaf.shape[-1] == basis_leaf.shape[-1]
            else proj.LEFT)


def _clean(t: PyTree) -> PyTree:
    """Non-finite entries as 0 (tensors and arrays; host ints pass)."""
    def one(x):
        if torch.is_tensor(x):
            return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        if isinstance(x, np.ndarray):
            return np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        return x
    return tree.tree_map(one, t)


class PopulationRunner:
    """Drives ``FedEngine`` rounds against a virtual population.

    Per round: sample the plan → merge due stale updates into the global
    state → gather the cohort's sticky rows → run the masked (guarded,
    when the plan has adversaries or the engine quarantines) round →
    harvest the retained client buffers → push stragglers → scatter rows
    of the live honest clients → record drift.

    ``batches_for(ids, round_idx)`` supplies the cohort's local data with
    leading (C, T, ...) axes. Requires the fused factored-𝒮 round
    (``fused_round and factored_sync``), whose client buffers the engine
    retains (it sets ``retain_clients``). ``snapshot_dir`` + ``snapshot_every`` persist the whole
    federation through the checkpoint writer; ``drift_tripwire`` /
    ``loss_tripwire`` arm a rollback-and-replay guard with the offending
    clients quarantined, for at most ``tripwire_retries`` replays.
    """

    def __init__(self, engine, batches_for: Callable[[np.ndarray, int], PyTree],
                 cohort: int, pcfg: Optional[ParticipationConfig] = None,
                 store_dir: Optional[str] = None, shard_size: int = 1024,
                 max_resident_shards: Optional[int] = None,
                 buffer_capacity: Optional[int] = None,
                 snapshot_dir: Optional[str] = None, snapshot_every: int = 0,
                 snapshot_keep: int = 3, drift_tripwire: float = 0.0,
                 loss_tripwire: float = 0.0, tripwire_retries: int = 1):
        if not (engine.cfg.fused_round and engine.cfg.factored_sync):
            raise ValueError("PopulationRunner requires the fused factored "
                             "round (it harvests the retained client "
                             "buffers)")
        self.engine = engine
        engine.retain_clients = True
        self.batches_for = batches_for
        self.cohort = int(cohort)
        self.pcfg = pcfg or engine.cfg.participation or ParticipationConfig()
        self.population = self.pcfg.population or self.cohort
        self.store = ClientStateStore(
            self.population, self._row_template(), directory=store_dir,
            shard_size=shard_size, max_resident_shards=max_resident_shards)
        self.buffer = StalenessBuffer(capacity=buffer_capacity)
        self.history: List[Dict[str, float]] = []
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self.snapshot_keep = int(snapshot_keep)
        self.drift_tripwire = float(drift_tripwire)
        self.loss_tripwire = float(loss_tripwire)
        self.tripwire_retries = int(tripwire_retries)
        self._last_harvest: Optional[Dict[str, PyTree]] = None

    # -- templates / layout --
    def _zeros_like_tree(self, t: PyTree) -> PyTree:
        return tree.tree_map(
            lambda x: None if x is None else np.zeros(tuple(x.shape),
                                                      np.float32),
            t, is_leaf=_is_none)

    def _galore_shapes(self):
        g = gal.galore_state_of(self.engine._fresh_opt)
        return self._zeros_like_tree(gal.extract_projected_v(g))

    def _row_template(self) -> PyTree:
        """Per-client sticky row: factored accumulator + projected moments
        (GaLore clients), or the dense trainable delta (+ moments)."""
        eng = self.engine
        if eng._factored:
            moments = self._galore_shapes()
            return {"delta": moments, "v": moments}
        row = {"delta": self._zeros_like_tree(eng.global_trainable)}
        if eng.spec.optimizer == "galore_adamw":
            row["v"] = self._galore_shapes()
        return row

    def _base_scale(self) -> float:
        """(1-ηλ)^T, identical across clients under the constant lr."""
        c = self.engine.cfg
        return float((1.0 - c.lr * c.weight_decay) ** c.local_steps)

    # -- harvest: the engine's retained post-round buffers, on the host --
    def _harvest(self) -> Dict[str, PyTree]:
        eng = self.engine
        to_np = lambda t: tree.tree_map(  # noqa: E731
            lambda x: None if x is None else _host(x), t, is_leaf=_is_none)
        out: Dict[str, PyTree] = {
            "delta" if eng._factored else "trainable":
                to_np(eng._client_state)}
        if eng.spec.optimizer == "galore_adamw":
            g = gal.galore_state_of(eng._client_opt)
            out["v"] = to_np(gal.extract_projected_v(g))
            out["bases"] = to_np(gal.extract_bases(g))
        return out

    @staticmethod
    def _rows(t: Optional[PyTree], sel) -> Optional[PyTree]:
        if t is None:
            return None
        return tree.tree_map(lambda x: None if x is None else x[sel], t,
                             is_leaf=_is_none)

    # -- stale merge --
    @torch.no_grad()
    def _merge_due(self, round_idx: int) -> Dict[str, float]:
        """Apply the due stale contributions to the engine's global state
        before the round runs (FedBuff server step), on the engine's
        device in float64.

        Weights: ``W ← W·(1 + Σ_j α_j (s_j − 1)) + Σ_j α_j·lift(R_j, B_j)``
        for factored clients, entry by entry, or ``W ← W + Σ_j α_j Δ_j``
        for dense deltas, with α_j = weight_j · decay_j. Moments:
        ``v̄ ← (1−ρ)·v̄ + ρ·(Σ α_j ṽ_j→now / Σα)``, ρ = Σα/(1+Σα), each
        stale ṽ re-based from its birth basis onto the current one,
        clamped ≥ 0.
        """
        due = self.buffer.pop_due(round_idx)
        if not due:
            return {"stale_merged": 0, "stale_weight_err": 0.0,
                    "stale_moment_div": 0.0}
        eng = self.engine
        dev = eng.device
        tmap = tree.tree_map
        t32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        g_old = eng.global_trainable
        g_acc = tmap(lambda x: x.to(torch.float64), g_old)
        for e in due:
            alpha = e.weight * e.decay
            if e.bases is not None:
                lifted = tmap(
                    lambda d, b: proj.project_back(
                        t32(d), t32(b), _moment_leaf_side(d, b)).to(
                            torch.float64),
                    e.deltas, e.bases)
                g_acc = tmap(
                    lambda acc, l, a=alpha, s=e.base_scale:
                        acc + a * (s - 1.0) * acc + a * l,
                    g_acc, lifted)
                del lifted
            else:
                g_acc = tmap(lambda acc, d, a=alpha: acc + a * _f64(d, dev),
                             g_acc, e.deltas)
        g_new = tmap(lambda acc, x: acc.to(torch.float32).to(x.dtype),
                     g_acc, g_old)
        del g_acc
        weight_err = tree_rel_err(g_new, g_old)
        eng.global_trainable = g_new

        stale_div = 0.0
        v_entries = [(e, e.weight * e.decay) for e in due
                     if e.v_rows is not None]
        if eng.synced_v is not None and v_entries:
            if any(e.bases is None for e, _ in v_entries):
                # The reference buffers no birth bases for dense clients,
                # and its re-projection fails on them the same way.
                raise ValueError(
                    "stale projected moments of dense-client GaLore "
                    "(factored_clients=False) have no birth bases to "
                    "re-project from (ROADMAP Queue 3 s)")
            cur0 = tmap(lambda b: b[0], gal.extract_bases(
                gal.galore_state_of(eng._client_opt)))
            a_sum = sum(a for _, a in v_entries)
            rho = a_sum / (1.0 + a_sum)
            moved_list = []
            acc = None
            for e, alpha in v_entries:
                moved = tmap(
                    lambda v, b, c: proj.reproject(
                        t32(v), t32(b), c.float(),
                        _moment_leaf_side(v, b)).to(torch.float64),
                    e.v_rows, e.bases, cur0)
                moved_list.append(moved)
                acc = (tmap(lambda m, a=alpha: a * m, moved) if acc is None
                       else tmap(lambda s, m, a=alpha: s + a * m, acc, moved))
            v_bar_old = tmap(lambda v: v.to(torch.float64), eng.synced_v)
            eng.synced_v = tmap(
                lambda vb, s: torch.clamp(
                    (1.0 - rho) * vb + rho * (s / a_sum), min=0.0).to(
                        torch.float32),
                v_bar_old, acc)
            stale_div = moment_divergence(
                tmap(lambda *ms: torch.stack(ms), *moved_list), v_bar_old,
                weights=np.asarray([a for _, a in v_entries]))
        return {"stale_merged": len(due), "stale_weight_err": weight_err,
                "stale_moment_div": stale_div}

    # -- one population round --
    def run_round(self, weights: Optional[np.ndarray] = None
                  ) -> Dict[str, Any]:
        eng = self.engine
        plan = sample_cohort(self.pcfg, self.cohort, eng.round_idx,
                             self.population)
        tripwire = self.drift_tripwire > 0.0 or self.loss_tripwire > 0.0
        guard = self._capture(plan) if tripwire else None
        record = self._execute_round(plan, weights)

        replays = 0
        quarantined = np.zeros(self.cohort, bool)
        while tripwire and self._tripped(record):
            offenders = (self._offending_clients()
                         & plan.mask & ~quarantined)
            new_q = quarantined | offenders
            still_live = (plan.mask & ~new_q).any()
            if (replays >= self.tripwire_retries or not offenders.any()
                    or not still_live):
                warnings.warn(
                    "tripwire: round %d still exceeds thresholds after %d "
                    "replay(s) (drift=%.3g loss=%.3g); degrading — keeping "
                    "the tripped round's result"
                    % (record["round"], replays,
                       record["moment_divergence"],
                       record["mean_final_loss"]))
                break
            quarantined = new_q
            self._rollback(guard)
            # Quarantined clients drop out: masked, no delay slot, and no
            # corruption code (the attack must not re-inject NaN).
            replay_plan = plan._replace(
                mask=plan.mask & ~quarantined,
                delays=np.where(quarantined, -1, plan.delays),
                corrupt=(None if plan.corrupt is None else
                         np.where(quarantined, 0, plan.corrupt)))
            record = self._execute_round(replay_plan, weights)
            replays += 1
        if tripwire:
            extra = {"tripwire_replays": replays,
                     "tripwire_quarantined": int(quarantined.sum())}
            self.history[-1].update(extra)
            record.update(extra)

        if (self.snapshot_dir is not None and self.snapshot_every > 0
                and eng.round_idx % self.snapshot_every == 0):
            self.snapshot()
        return record

    def _execute_round(self, plan: CohortPlan,
                       weights: Optional[np.ndarray]) -> Dict[str, Any]:
        eng = self.engine
        t = eng.round_idx
        stale_metrics = self._merge_due(t)
        gathered = self.store.gather(plan.clients)
        batches = self.batches_for(plan.clients, t)
        prev_global = None
        if not eng._factored:
            # Dense clients report stale deltas against their birth
            # round's global.
            prev_global = tree.tree_map(
                lambda x: _host(x).astype(np.float32), eng.global_trainable)
        attack = corruption_multipliers(plan, self.pcfg)
        metrics = eng.run_round(batches, weights=weights, mask=plan.mask,
                                attack=attack)

        harvest = self._harvest()
        self._last_harvest = harvest
        scale = self._base_scale()
        w_norm = _host(eng._normalize_weights(weights, self.cohort))

        # Stragglers (honest by construction: corruption is on-time only).
        evict0 = self.buffer.evictions
        for i in np.nonzero(plan.delays > 0)[0]:
            delay = int(plan.delays[i])
            if eng._factored:
                deltas = self._rows(harvest["delta"], i)
                bases = self._rows(harvest["bases"], i)
            else:
                deltas = tree.tree_map(
                    lambda a, b: np.asarray(a, np.float32) - b,
                    self._rows(harvest["trainable"], i), prev_global)
                bases = None
            self.buffer.push(StaleEntry(
                client_id=int(plan.clients[i]), birth_round=t,
                due_round=t + delay, weight=float(w_norm[i]),
                decay=float(self.pcfg.staleness_decay ** delay
                            * self.pcfg.stale_scale),
                base_scale=scale, deltas=deltas, bases=bases,
                v_rows=self._rows(harvest.get("v"), i)))

        # Participants and stragglers persist their rows; dropped and
        # corrupted clients keep their previous ones.
        live = plan.delays >= 0
        if plan.corrupt is not None:
            live = live & (plan.corrupt == 0)
        if live.any():
            rows: Dict[str, PyTree] = {}
            if eng._factored:
                rows["delta"] = self._rows(harvest["delta"], live)
                rows["v"] = self._rows(harvest["v"], live)
            else:
                rows["delta"] = tree.tree_map(
                    lambda a, b: np.asarray(a, np.float32)[live] - b[None],
                    harvest["trainable"], prev_global)
                if "v" in harvest:
                    rows["v"] = self._rows(harvest["v"], live)
            self.store.scatter(plan.clients[live], rows, round_idx=t)

        drift = 0.0
        if eng.synced_v is not None and "v" in harvest:
            on = plan.mask
            drift = moment_divergence(self._rows(harvest["v"], on),
                                      eng.synced_v, weights=w_norm[on])

        losses = _host(metrics["local_loss"])
        record = {
            "round": int(t),
            "participants": int(plan.mask.sum()),
            "dropped": int((plan.delays < 0).sum()),
            "straggling": int((plan.delays > 0).sum()),
            "buffered": len(self.buffer),
            "moment_divergence": drift,
            "mean_final_loss": float(losses[plan.mask, -1].mean()),
            "corrupted": (0 if plan.corrupt is None
                          else int((plan.corrupt != 0).sum())),
            "stale_evicted": self.buffer.evictions - evict0,
            **stale_metrics,
        }
        self.history.append(record)
        record = dict(record)
        record["plan"] = plan
        record["gathered"] = gathered
        record["local_loss"] = metrics["local_loss"]
        record["quarantined"] = (None if eng.quarantined is None
                                 else _host(eng.quarantined))
        return record

    # -- tripwire: capture / detect / rollback / screen --
    def _capture(self, plan: CohortPlan) -> Dict[str, Any]:
        """Round-start state for rollback. Every round replaces the
        engine's global, synced and frozen trees rather than writing into
        them, so references suffice; host state is copied."""
        eng = self.engine
        cap = {"global": eng.global_trainable, "synced": eng.synced_v,
               "round_idx": eng.round_idx,
               "entries": list(self.buffer._entries),
               "evictions": self.buffer.evictions,
               "history_len": len(self.history),
               "clients": plan.clients.copy(),
               "rows": self.store.gather(plan.clients),
               "last_round": self.store.last_round.copy()}
        if eng._frozen_mutates():
            cap["frozen"] = eng.frozen
        return cap

    def _rollback(self, cap: Dict[str, Any]) -> None:
        eng = self.engine
        eng.global_trainable = cap["global"]
        eng.synced_v = cap["synced"]
        if "frozen" in cap:
            eng.frozen = cap["frozen"]
        eng.round_idx = cap["round_idx"]
        self.buffer._entries = list(cap["entries"])
        self.buffer.evictions = cap["evictions"]
        del self.history[cap["history_len"]:]
        self.store.scatter(cap["clients"], cap["rows"])
        self.store.last_round = cap["last_round"].copy()

    def _tripped(self, record: Dict[str, Any]) -> bool:
        loss = record["mean_final_loss"]
        drift = record["moment_divergence"]
        if not (np.isfinite(loss) and np.isfinite(drift)):
            return True
        if self.loss_tripwire > 0.0 and loss > self.loss_tripwire:
            return True
        return self.drift_tripwire > 0.0 and drift > self.drift_tripwire

    def _offending_clients(self) -> np.ndarray:
        """Host-side screen of the last harvested uplink in float64: a
        client offends when any retained buffer is non-finite, or when
        its norm exceeds ``quarantine_zmax`` × the cohort median norm."""
        h = self._last_harvest
        if h is None:
            return np.zeros(self.cohort, bool)
        finite = np.ones(self.cohort, bool)
        sq = np.zeros(self.cohort)
        delta_tree = h["delta"] if "delta" in h else h["trainable"]
        for t in (delta_tree, h.get("v")):
            if t is None:
                continue
            for x in tree.tree_leaves(t, is_leaf=_is_none):
                if x is None:
                    continue
                x2 = np.asarray(x, np.float64).reshape(self.cohort, -1)
                ok = np.isfinite(x2)
                finite &= ok.all(axis=1)
                x2 = np.where(ok, x2, 0.0)
                sq += (x2 * x2).sum(axis=1)
        norm = np.sqrt(sq)
        out = ~finite
        med = np.median(norm[finite]) if finite.any() else 0.0
        if med > 0.0:
            out |= norm > self.engine.cfg.quarantine_zmax * med
        return out

    # -- snapshots: crash-resumable federation state --
    def _entry_template(self) -> Dict[str, Optional[PyTree]]:
        eng = self.engine
        if eng._factored:
            moments = self._galore_shapes()
            bases = self._zeros_like_tree(gal.extract_bases(
                gal.galore_state_of(eng._fresh_opt)))
            return {"deltas": moments, "bases": bases, "v_rows": moments}
        row = {"deltas": self._zeros_like_tree(eng.global_trainable),
               "bases": None, "v_rows": None}
        if eng.spec.optimizer == "galore_adamw":
            row["v_rows"] = self._galore_shapes()
        return row

    def snapshot(self, step: Optional[int] = None) -> int:
        """Persist the whole federation atomically: global trainable,
        retained client buffers (non-finite entries as 0: they are rebuilt
        at round start and must not trip the restore-side check),
        staleness-buffer entries, the store's round stamps, and
        synced_v/frozen when live, through the checkpoint writer
        (``fed_{step}.npz``); scalars in ``fed_{step}.meta.json`` with the
        same tmp + rename. Keeps ``snapshot_keep`` snapshots."""
        if self.snapshot_dir is None:
            raise ValueError("snapshot_dir is not configured")
        eng = self.engine
        step = int(eng.round_idx if step is None else step)
        self.store.flush()
        eng._ensure_client_buffers(self.cohort)
        payload: Dict[str, Any] = {
            "global": eng.global_trainable,
            "client_state": _clean(eng._client_state),
            "client_opt": _clean(eng._client_opt),
            "last_round": self.store.last_round,
            "entries": [{"deltas": _clean(e.deltas),
                         "bases": _clean(e.bases),
                         "v_rows": _clean(e.v_rows)}
                        for e in self.buffer._entries]}
        if eng.synced_v is not None:
            payload["synced_v"] = eng.synced_v
        if eng._frozen_mutates():
            payload["frozen"] = eng.frozen
        ckpt_io.save(self.snapshot_dir, step, payload, name="fed",
                     keep_last=self.snapshot_keep)
        meta = {"round_idx": int(eng.round_idx),
                "history": self.history,
                "has_synced_v": eng.synced_v is not None,
                "has_frozen": bool(eng._frozen_mutates()),
                "buffer_evictions": int(self.buffer.evictions),
                "entries": [{"client_id": int(e.client_id),
                             "birth_round": int(e.birth_round),
                             "due_round": int(e.due_round),
                             "weight": float(e.weight),
                             "decay": float(e.decay),
                             "base_scale": float(e.base_scale),
                             "has_bases": e.bases is not None,
                             "has_v": e.v_rows is not None}
                            for e in self.buffer._entries]}
        mpath = os.path.join(self.snapshot_dir, "fed_%08d.meta.json" % step)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, mpath)
        return step

    def restore(self, step: Optional[int] = None) -> int:
        """Rebuild the federation from a snapshot (the latest when ``step``
        is None): build a fresh runner with the same config, then
        ``restore()``. A non-finite payload fails here."""
        if self.snapshot_dir is None:
            raise ValueError("snapshot_dir is not configured")
        if step is None:
            step = ckpt_io.latest_step(self.snapshot_dir, name="fed")
            if step is None:
                raise FileNotFoundError(
                    "no federation snapshot found in %r" % self.snapshot_dir)
        step = int(step)
        with open(os.path.join(self.snapshot_dir,
                               "fed_%08d.meta.json" % step)) as f:
            meta = json.load(f)
        eng = self.engine
        eng._ensure_client_buffers(self.cohort)
        base_entry = self._entry_template()
        entry_templates = []
        for info in meta["entries"]:
            t = dict(base_entry)
            if not info["has_bases"]:
                t["bases"] = None
            if not info["has_v"]:
                t["v_rows"] = None
            entry_templates.append(t)
        template: Dict[str, Any] = {
            "global": eng.global_trainable,
            "client_state": eng._client_state,
            "client_opt": eng._client_opt,
            "last_round": self.store.last_round,
            "entries": entry_templates}
        if meta["has_synced_v"]:
            template["synced_v"] = (eng.synced_v if eng.synced_v is not None
                                    else eng._zero_synced_template())
        if meta["has_frozen"]:
            template["frozen"] = eng.frozen
        data = ckpt_io.restore(self.snapshot_dir, step, template, name="fed")
        eng.global_trainable = data["global"]
        eng._client_state = data["client_state"]
        eng._client_opt = data["client_opt"]
        eng.synced_v = data["synced_v"] if meta["has_synced_v"] else None
        if meta["has_frozen"]:
            eng.frozen = data["frozen"]
        eng.round_idx = int(meta["round_idx"])
        self.history = list(meta["history"])
        self.store.last_round = np.asarray(data["last_round"], np.int64)
        self.buffer._entries = [
            StaleEntry(client_id=int(info["client_id"]),
                       birth_round=int(info["birth_round"]),
                       due_round=int(info["due_round"]),
                       weight=float(info["weight"]),
                       decay=float(info["decay"]),
                       base_scale=float(info["base_scale"]),
                       deltas=trees["deltas"],
                       bases=trees["bases"] if info["has_bases"] else None,
                       v_rows=trees["v_rows"] if info["has_v"] else None)
            for info, trees in zip(meta["entries"], data["entries"])]
        self.buffer.evictions = int(meta.get("buffer_evictions", 0))
        self._last_harvest = None
        return step

    def run_rounds(self, k_rounds: int,
                   weights: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """K sequential population rounds (stale merges change the state
        on the host between rounds)."""
        out = None
        for _ in range(int(k_rounds)):
            out = self.run_round(weights=weights)
        self.store.flush()
        return {"history": self.history[-int(k_rounds):], "last": out}
