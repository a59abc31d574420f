"""Host-side sticky client state (port of
``repro/core/population.py::ClientStateStore``, resident shards only).

Spilling cold shards to a ``directory`` needs the checkpoint writer,
which is ROADMAP Queue 1 item 10 (population and robustness); until it is
ported, passing a ``directory`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..utils import tree

PyTree = Any


class ClientStateStore:
    """Host-side sticky state for a virtual client population.

    Rows are stored in contiguous per-shard numpy arrays (``shard_size``
    clients per shard), all resident. A client that has never been
    scattered reads back as zeros (cold).

    ``template`` is a pytree of per-client leaves (no leading client axis);
    gather/scatter speak (len(ids), ·) stacked trees of the same structure.
    """

    def __init__(self, n_clients: int, template: PyTree,
                 directory: Optional[str] = None, shard_size: int = 1024,
                 max_resident_shards: Optional[int] = None):
        if directory is not None:
            raise NotImplementedError(
                "ClientStateStore spill to a directory is not ported yet "
                "(ROADMAP Queue 1 item 10: population and robustness, with "
                "checkpoint/io.py)")
        self.n_clients = int(n_clients)
        self.shard_size = int(shard_size)
        self.n_shards = -(-self.n_clients // self.shard_size)
        if max_resident_shards is not None and \
                max_resident_shards < self.n_shards:
            raise ValueError("spill requires a directory: "
                             f"{self.n_shards} shards > resident cap "
                             f"{max_resident_shards}")
        leaves, self._treedef = tree.tree_flatten(template)
        self._specs = [(tuple(np.shape(x)), np.dtype(np.asarray(x).dtype))
                       for x in leaves]
        self._resident: dict = {}

    def _shard_rows(self, shard: int) -> int:
        lo = shard * self.shard_size
        return min(self.shard_size, self.n_clients - lo)

    def _ensure_resident(self, shard: int) -> list:
        if shard not in self._resident:
            rows = self._shard_rows(shard)
            self._resident[shard] = [np.zeros((rows,) + shape, dtype)
                                     for shape, dtype in self._specs]
        return self._resident[shard]

    def gather(self, ids: np.ndarray) -> PyTree:
        """Rows for ``ids`` as a stacked (len(ids), ·) pytree (zeros for
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

    def scatter(self, ids: np.ndarray, rows: PyTree):
        """Write stacked rows back under population ids."""
        ids = np.asarray(ids, np.int64)
        leaves = tree.tree_leaves(rows)
        if len(leaves) != len(self._specs):
            raise ValueError("scatter tree structure != store template")
        leaves = [np.asarray(x) for x in leaves]
        shards = ids // self.shard_size
        for shard in np.unique(shards):
            sel = np.nonzero(shards == shard)[0]
            rel = ids[sel] - shard * self.shard_size
            data = self._ensure_resident(int(shard))
            for d, leaf in zip(data, leaves):
                d[rel] = leaf[sel]
