"""Client batching: task + partition -> per-round stacked batches with
leading (K clients, T local steps, batch, ...) axes. Each client's shard
cycles with a reshuffle per epoch, so one protocol drives IID and
Dirichlet partitions."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .partition import dirichlet_label_partition, iid_partition
from .synthetic import TaskData


class FederatedBatcher:
    def __init__(self, task: TaskData, n_clients: int, batch_size: int,
                 alpha: Optional[float] = None, seed: int = 0):
        """alpha=None -> IID; else Dirichlet(alpha) label partition."""
        self.task = task
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed + 1)
        if alpha is None:
            self.parts = iid_partition(len(task.tokens), n_clients, seed)
        else:
            self.parts = dirichlet_label_partition(task.class_ids, n_clients,
                                                   alpha, seed)
        self._cursors = [0] * n_clients

    def _next_idx(self, client: int, n: int) -> np.ndarray:
        part = self.parts[client]
        out = []
        c = self._cursors[client]
        while n > 0:
            if c >= len(part):
                self.rng.shuffle(part)
                c = 0
            take = min(n, len(part) - c)
            out.append(part[c:c + take])
            c += take
            n -= take
        self._cursors[client] = c
        return np.concatenate(out)

    def round_batches(self, local_steps: int,
                      clients: Optional[List[int]] = None) -> Dict:
        """-> dict of arrays with leading (K, T, B) axes."""
        clients = clients if clients is not None else range(len(self.parts))
        toks, labs = [], []
        for ci in clients:
            idx = self._next_idx(ci, local_steps * self.batch_size)
            idx = idx.reshape(local_steps, self.batch_size)
            toks.append(self.task.tokens[idx])
            labs.append(self.task.labels[idx])
        return {"tokens": np.stack(toks), "labels": np.stack(labs)}

    def eval_batch(self, n: int, seed: int = 123) -> Dict:
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(self.task.tokens), size=n, replace=False)
        return {"tokens": self.task.tokens[idx],
                "labels": self.task.labels[idx]}
