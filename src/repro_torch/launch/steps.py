"""Target-module selection (port of ``repro/launch/steps.py::
galore_target_fn``)."""
from __future__ import annotations

from typing import Callable

from ..configs.base import ArchConfig


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
