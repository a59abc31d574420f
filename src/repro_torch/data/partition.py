"""Dirichlet non-IID client partitioning (paper Appendix H): each client's
label distribution is ``p_i ~ Dir(α·1_K)``; smaller α ⇒ more skewed
clients (the paper's severe setting is α = 0.5)."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_label_partition(labels: np.ndarray, n_clients: int,
                              alpha: float, seed: int = 0,
                              min_per_client: int = 1) -> List[np.ndarray]:
    """Return per-client index arrays partitioning ``labels``."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(n_clients))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    out = []
    all_idx = np.arange(len(labels))
    for ci in range(n_clients):
        idx = np.asarray(client_idx[ci], dtype=np.int64)
        if len(idx) < min_per_client:   # top up starved clients uniformly
            extra = rng.choice(all_idx, size=min_per_client - len(idx),
                               replace=False)
            idx = np.concatenate([idx, extra])
        rng.shuffle(idx)
        out.append(idx)
    return out


def iid_partition(n_examples: int, n_clients: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_examples)
    return [np.asarray(part) for part in np.array_split(idx, n_clients)]


def heterogeneity_stats(labels: np.ndarray, parts: List[np.ndarray]) -> dict:
    """Diagnostics: per-client class histograms + mean TV distance to the
    global distribution (a direct measure of the paper's drift c_i)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    global_p = np.array([(labels == c).mean() for c in classes])
    tvs = []
    hists = []
    for idx in parts:
        li = labels[idx]
        p = np.array([(li == c).mean() if len(li) else 0.0 for c in classes])
        hists.append(p)
        tvs.append(0.5 * np.abs(p - global_p).sum())
    return {"mean_tv": float(np.mean(tvs)), "per_client_tv": tvs,
            "hists": np.stack(hists)}
