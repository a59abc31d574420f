"""Carry the JAX package's params across to the port.

The caller turns the JAX tree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module never
imports JAX. A JAX ``MultiAdapterDelta`` node arrives as a ``NamedTuple``
of that name with numpy children and becomes the port's
:class:`~repro_torch.models.layers.MultiAdapterDelta`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils import tree
from .layers import MultiAdapterDelta

PyTree = Any


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16: same bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree_of_numpy: PyTree, device, dtype=None) -> PyTree:
    """The port's params with the JAX tree's keys and dtypes on
    ``device``. ``dtype`` (optional) casts the floating weights; adapter
    tables and scales stay fp32, the layout the serving kernel takes."""
    def is_adapter(x):
        return (isinstance(x, tuple)
                and type(x).__name__ == MultiAdapterDelta.__name__)

    def convert(x):
        if is_adapter(x):
            return MultiAdapterDelta(
                w=_to_tensor(x.w, device, dtype),
                bases=_to_tensor(x.bases, device, None),
                rts=_to_tensor(x.rts, device, None),
                scales=_to_tensor(x.scales, device, None))
        return _to_tensor(x, device, dtype)

    return tree.tree_map(convert, tree_of_numpy, is_leaf=is_adapter)
