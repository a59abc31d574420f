"""Target split of a param tree (port of ``repro/core/fed.py``:
``split_trainable``, ``merge_dense``)."""
from __future__ import annotations

from typing import Any

from ..utils import tree

PyTree = Any


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
