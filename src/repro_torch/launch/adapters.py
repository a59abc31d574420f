"""Sticky multi-tenant adapter factors for the serving path (port of
``repro/launch/adapters.py``).

:class:`AdapterStore` keeps per-tenant factored deltas ``(basis, R̃,
base_scale)`` as rows of a :class:`~repro_torch.core.population.
ClientStateStore` (host numpy, fp32). A tenant that was never stored reads
back as zeros, which decodes as the pristine base model
(``scale_minus_1 = 0`` ⇒ scale 1, delta 0).

``wrap`` lifts a base param tree into :class:`MultiAdapterDelta` serving
leaves whose ``(nb, G, dim, r)`` fp32 tables sit on the base weight's
device; the decode batch's per-row adapter ids (installed with
:func:`repro_torch.models.layers.adapter_ids`) select each row's tenant.

Ragged ranks: tenants may store factors with r_g < the table rank; they
are zero-padded per shape bucket and contribute exactly zero delta.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from ..core import projector as proj
from ..core.fed import merge_dense, split_trainable
from ..core.galore import bucket_by_shape
from ..core.population import ClientStateStore
from ..models import layers
from ..utils import tree
from .steps import galore_target_fn

PyTree = Any


def serving_target_fn(cfg):
    """The training target set minus MLA's ``kv_b`` (absorbed at decode)."""
    base = galore_target_fn(cfg)

    def fn(path: str, leaf) -> bool:
        if path.split("/")[-1] == "kv_b":
            return False
        return base(path, leaf)

    return fn


def _pad_bucketed(leaves: List, axes: List[int], rank: int) -> List:
    """Zero-pad ragged-rank factor leaves to the store rank along their
    rank axis. Leaves sharing a (shape, axis) layout are padded as one
    stacked block — one np op per shape bucket."""
    keys = [(tuple(np.shape(x)), ax) for x, ax in zip(leaves, axes)]
    buckets, _ = bucket_by_shape(keys)
    out = list(leaves)
    for (shape, ax), idxs in buckets:
        block = np.stack([np.asarray(leaves[i], np.float32) for i in idxs])
        have = shape[ax]
        if have > rank:
            raise ValueError(f"factor rank {have} exceeds store rank {rank}")
        if have < rank:
            widths = [(0, 0)] * block.ndim
            widths[ax % (block.ndim - 1) + 1] = (0, rank - have)
            block = np.pad(block, widths)
        for j, i in enumerate(idxs):
            out[i] = block[j]
    return out


class AdapterStore:
    """Per-tenant serving factors keyed by adapter id.

    ``params``/``target_fn`` fix the leaf layout: every target leaf
    ``(..., m, n)`` gets a basis row ``(..., dim, rank)`` and an R̃ row
    (``(..., m, rank)`` right / ``(..., rank, n)`` left, GaLore ``std``
    side convention). With a ``directory``, shards beyond
    ``max_resident_shards`` spill there through the client-state store,
    in the reference's file format.
    """

    def __init__(self, params: PyTree, target_fn, n_adapters: int,
                 rank: int, directory: Optional[str] = None,
                 shard_size: int = 1024,
                 max_resident_shards: Optional[int] = None):
        self.n_adapters = int(n_adapters)
        self.rank = int(rank)
        self._target_fn = target_fn
        trainable, _ = split_trainable(params, target_fn)
        w_leaves, tdef = tree.tree_flatten(trainable)
        if not w_leaves:
            raise ValueError("target_fn selected no servable leaves")
        self._tdef = tdef
        self._sides = [proj.proj_side(tuple(w.shape)) for w in w_leaves]
        self._basis_specs, self._rt_specs = [], []
        for w, side in zip(w_leaves, self._sides):
            lead, (m, n) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
            if side == proj.RIGHT:
                self._basis_specs.append(lead + (n, self.rank))
                self._rt_specs.append(lead + (m, self.rank))
            else:
                self._basis_specs.append(lead + (m, self.rank))
                self._rt_specs.append(lead + (self.rank, n))
        template = {
            "basis": tdef.unflatten(
                [np.zeros(s, np.float32) for s in self._basis_specs]),
            "rt": tdef.unflatten(
                [np.zeros(s, np.float32) for s in self._rt_specs]),
            "scale_minus_1": np.zeros((), np.float32),
        }
        self.store = ClientStateStore(
            self.n_adapters, template, directory=directory,
            shard_size=shard_size, max_resident_shards=max_resident_shards)

    # rank axis per leaf: basis pads its last axis; R̃ pads last on the
    # right side, -2 on the left.
    def _rt_axes(self) -> List[int]:
        return [-1 if s == proj.RIGHT else -2 for s in self._sides]

    def put(self, adapter_id: int, rt: PyTree, basis: PyTree,
            scale: float = 1.0) -> None:
        """Store one tenant's factors. ``rt``/``basis`` trees follow the
        trainable split layout; their leaves may carry a smaller (ragged)
        rank r_g <= the store rank — zero-padded on write."""
        b_leaves = tree.tree_leaves(basis)
        r_leaves = tree.tree_leaves(rt)
        if len(b_leaves) != len(self._sides) or \
                len(r_leaves) != len(self._sides):
            raise ValueError("factor tree layout != store template")
        b_leaves = _pad_bucketed(b_leaves, [-1] * len(b_leaves), self.rank)
        r_leaves = _pad_bucketed(r_leaves, self._rt_axes(), self.rank)
        row = {"basis": self._tdef.unflatten(b_leaves),
               "rt": self._tdef.unflatten(r_leaves),
               "scale_minus_1": np.float32(scale) - np.float32(1.0)}
        stacked = tree.tree_map(lambda x: np.asarray(x, np.float32)[None],
                                row)
        self.store.scatter(np.asarray([adapter_id]), stacked)

    def wrap(self, params: PyTree, ids=None) -> PyTree:
        """Params with each target leaf replaced by a MultiAdapterDelta
        carrying the gathered fp32 factor tables for ``ids`` (default: all
        adapters, in id order) on that leaf's device. Decode-row adapter
        ids then index INTO THIS TABLE (positions in ``ids``)."""
        ids = (np.arange(self.n_adapters) if ids is None
               else np.asarray(ids, np.int64))
        rows = self.store.gather(ids)
        scales = np.asarray(rows["scale_minus_1"], np.float32) + 1.0  # (G,)
        trainable, frozen = split_trainable(params, self._target_fn)
        w_leaves, tdef = tree.tree_flatten(trainable)
        b_leaves = tree.tree_leaves(rows["basis"])
        r_leaves = tree.tree_leaves(rows["rt"])
        wrapped = []
        for w, b, r in zip(w_leaves, b_leaves, r_leaves):
            # gathered (G, ..., dim, r) -> table (..., G, dim, r): the G
            # axis sits just before the factor matrix so the per-layer
            # view [i] of a stacked leaf is a contiguous (G, dim, r).
            def table(a):
                a = np.ascontiguousarray(np.moveaxis(a, 0, a.ndim - 3))
                return torch.from_numpy(a).to(w.device)
            sc = torch.from_numpy(scales).to(w.device)
            sc = sc.expand(tuple(w.shape[:-2]) + sc.shape).contiguous()
            wrapped.append(layers.MultiAdapterDelta(
                w=w, bases=table(b), rts=table(r), scales=sc))
        return merge_dense(frozen, tdef.unflatten(wrapped))

    def random_factors(self, rng: np.random.Generator,
                       rt_scale: float = 0.02):
        """A random (basis, rt) tree pair in this store's layout — demo
        tenants and test fixtures."""
        basis = self._tdef.unflatten(
            [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[-2])
             for s in self._basis_specs])
        rt = self._tdef.unflatten(
            [rt_scale * rng.standard_normal(s).astype(np.float32)
             for s in self._rt_specs])
        return basis, rt

    @classmethod
    def from_client_state(cls, params: PyTree, target_fn,
                          client_store: ClientStateStore, basis: PyTree,
                          ids, base_scale: float = 1.0,
                          rank: Optional[int] = None, **kw) -> "AdapterStore":
        """Serve a trained population directly: client ``i``'s sticky
        factored accumulator (row key ``"delta"``) becomes adapter ``i``'s
        R̃, paired with the shared ``basis`` tree and ``base_scale``.
        Adapter ids == population client ids."""
        ids = np.asarray(ids, np.int64)
        rows = client_store.gather(ids)
        deltas = rows["delta"]
        if rank is None:
            rank = max(b.shape[-1] for b in tree.tree_leaves(basis))
        store = cls(params, target_fn, n_adapters=client_store.n_clients,
                    rank=rank, **kw)
        for g, cid in enumerate(ids):
            rt_i = tree.tree_map(lambda x: x[g], deltas)
            store.put(int(cid), rt_i, basis, scale=base_scale)
        return store


def demo_wrap(params: PyTree, cfg, n_adapters: int, rank: int = 4,
              seed: int = 0, rt_scale: float = 0.02) -> PyTree:
    """Wrap ``params`` with ``n_adapters`` random distinct tenants drawn
    from ``np.random.default_rng(seed)`` — the CLI demo path
    (``serve --adapters G``)."""
    store = AdapterStore(params, serving_target_fn(cfg), n_adapters, rank)
    rng = np.random.default_rng(seed)
    for g in range(n_adapters):
        basis, rt = store.random_factors(rng, rt_scale=rt_scale)
        store.put(g, rt, basis)
    return store.wrap(params)
