"""Carry the JAX package's params and optimizer state across to the port.

The caller turns the JAX tree into numpy first
(``jax.tree_util.tree_map(np.asarray, tree)``), so this module never
imports JAX. JAX ``NamedTuple`` nodes arrive as ``NamedTuple``s of their
own name with numpy children and become the port's classes of that name:
``MultiAdapterDelta`` in params; ``GaloreState``, ``GaloreBlockState``,
``DenseMoments`` and the chain's ``ClipState``, ``WeightDecayState`` and
``ScaleByLrState`` in an optimizer state (step counts and seeds become
host ints, as the port keeps them).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import galore as gal
from ..optim.adamw import WeightDecayState
from ..optim.base import ClipState, ScaleByLrState
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


def _is_node(name):
    return lambda x: isinstance(x, tuple) and type(x).__name__ == name


_STATELESS = {"ClipState": ClipState, "WeightDecayState": WeightDecayState}


def opt_state_from_jax(state_of_numpy, device):
    """The port's optimizer state from a JAX (possibly chained) GaLore
    optimizer state given as numpy: a ``GaloreState`` or a tuple of the
    chain's states."""
    def block(b):
        if _is_node("GaloreBlockState")(b):
            return gal.GaloreBlockState(
                basis=_to_tensor(b.basis, device, None),
                m=_to_tensor(b.m, device, None),
                v=_to_tensor(b.v, device, None))
        return gal.DenseMoments(m=_to_tensor(b.m, device, None),
                                v=_to_tensor(b.v, device, None))

    def one(s):
        name = type(s).__name__
        if name == "GaloreState":
            is_blk = lambda x: (_is_node("GaloreBlockState")(x)  # noqa: E731
                                or _is_node("DenseMoments")(x))
            return gal.GaloreState(
                count=int(s.count), seed=int(s.seed),
                blocks=tree.tree_map(block, s.blocks, is_leaf=is_blk))
        if name == "ScaleByLrState":
            return ScaleByLrState(count=int(s.count))
        if name in _STATELESS:
            return _STATELESS[name]()
        raise TypeError(f"no carry-across for optimizer state {name}")

    if _is_node("GaloreState")(state_of_numpy):
        return one(state_of_numpy)
    return tuple(one(s) for s in state_of_numpy)


def opt_state_to_numpy(state):
    """The port's optimizer state with every tensor as a numpy array (the
    inverse of :func:`opt_state_from_jax`, for round trips)."""
    return tree.tree_map(
        lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x,
        state)
