"""The slice of ``jax.tree_util`` the port needs, over dicts, lists, tuples,
``NamedTuple``s and ``None``.

Three JAX conventions hold exactly, because store rows, adapter-table leaf
order and target paths follow them:

- dict keys flatten in sorted order;
- ``NamedTuple``s flatten in field order;
- ``None`` is an empty subtree (no leaves), unless ``is_leaf`` claims it.

Path entries are the strings that ``"/".join(str(getattr(q, "key",
getattr(q, "idx", q))) ...)`` builds from JAX's path keys: a dict key as
``str(key)``, a sequence index as ``str(idx)``, a ``NamedTuple`` field as
``".name"`` — so ``path_str`` gives ``"blocks/0/attn/wq"``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(x):
    """(kind, keys, children) of an inner node, or None for a leaf."""
    if isinstance(x, dict):
        keys = sorted(x)
        return "dict", keys, [x[k] for k in keys]
    if _is_namedtuple(x):
        return type(x), list(x._fields), list(x)
    if isinstance(x, (list, tuple)):
        return type(x), list(range(len(x))), list(x)
    return None


def _path_entry(kind, key) -> str:
    if isinstance(kind, type) and hasattr(kind, "_fields"):
        return "." + key                   # NamedTuple field (GetAttrKey)
    return str(key)


class PyTreeDef:
    """The structure of a flattened tree; ``unflatten`` rebuilds it."""

    def __init__(self, kind, keys=(), children=()):
        self.kind = kind                   # "leaf" | "none" | dict | type
        self.keys = list(keys)
        self.children = list(children)

    def unflatten(self, leaves) -> PyTree:
        it = iter(list(leaves))
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("too many leaves for this tree structure")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError("too few leaves for this tree structure")
            return leaf
        if self.kind == "none":
            return None
        vals = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, vals))
        if hasattr(self.kind, "_fields"):
            return self.kind(*vals)
        return self.kind(vals)


_END = object()


def tree_flatten_with_path(tree: PyTree,
                           is_leaf: Optional[Callable] = None
                           ) -> Tuple[List[Tuple[tuple, Any]], PyTreeDef]:
    """``[(path, leaf), ...]`` in JAX order, and the tree's structure."""
    out: List[Tuple[tuple, Any]] = []

    def rec(x, path):
        if is_leaf is not None and is_leaf(x):
            out.append((path, x))
            return PyTreeDef("leaf")
        if x is None:
            return PyTreeDef("none")
        node = _children(x)
        if node is None:
            out.append((path, x))
            return PyTreeDef("leaf")
        kind, keys, kids = node
        defs = [rec(c, path + (_path_entry(kind, k),))
                for k, c in zip(keys, kids)]
        return PyTreeDef(kind, keys, defs)

    treedef = rec(tree, ())
    # rec's closure holds rec itself: left as it is, that cycle keeps
    # ``out`` and every leaf alive until the garbage collector runs.
    del rec
    return out, treedef


def tree_flatten(tree: PyTree, is_leaf: Optional[Callable] = None):
    leaves, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in leaves], treedef


def tree_leaves(tree: PyTree, is_leaf: Optional[Callable] = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def path_str(path: tuple) -> str:
    return "/".join(path)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable] = None) -> PyTree:
    """Map ``fn`` over the leaves of ``tree``; ``rest`` trees are read up to
    ``tree``'s structure (a leaf of ``tree`` may face a whole subtree of
    another tree, as in ``jax.tree_util.tree_map``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    kind, keys, kids = node
    if kind == "dict":
        for r in rest:
            if not isinstance(r, dict) or sorted(r) != keys:
                raise ValueError(f"dict keys differ: {keys} vs {r!r:.80}")
        return {k: tree_map(fn, c, *[r[k] for r in rest], is_leaf=is_leaf)
                for k, c in zip(keys, kids)}
    for r in rest:
        if not isinstance(r, tuple if kind is not list else list) or \
                len(r) != len(kids):
            raise ValueError(f"tree structure differs at {kind.__name__} "
                             f"of length {len(kids)}")
    vals = [tree_map(fn, c, *[r[i] for r in rest], is_leaf=is_leaf)
            for i, c in enumerate(kids)]
    return kind(*vals) if _is_namedtuple(tree) else kind(vals)
