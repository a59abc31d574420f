"""Sharding rules: param/state tree paths -> partition specs (port of
``repro/sharding/rules.py``).

Megatron-style tensor parallelism over the ``model`` axis plus FSDP-style
weight sharding over the ``data`` axis. The ``pod`` axis is pure
data/client parallelism — parameters replicate across pods, so the only
cross-pod traffic is the gradient / federated-aggregation all-reduce,
matching the paper's round structure.

Every rule degrades gracefully: an axis is only assigned to a dimension it
divides, so any (arch × mesh) combination resolves. Rules:

  COL  (d_in, d_out)        -> (fsdp, model)       wq/wk/wv/w_gate/w_up/...
  ROW  (d_in, d_out)        -> (model, fsdp)       wo/w_down/out_proj/...
  EXP  (E, d_in, d_out)     -> (model, fsdp, None) expert-parallel MoE
  EMB  (V, D)               -> (model, fsdp)       embeddings / lm head
  REPL                      -> ()                  norms, biases, routers

Stacked scan-block leaves get a leading None. GaLore states follow their
block's rule on the ambient dim (basis (n, r) of a COL block shards n over
model iff the block's n was model-sharded; projected buffers (m, r) follow m).

A spec is a tuple with one entry per leading dimension — an axis name, a
tuple of names, or None — and replicates the dimensions past its end, as
JAX's ``PartitionSpec`` does (a one-name tuple is written as the name, as
``PartitionSpec`` normalizes it). The rules read only axis names and
sizes, so they resolve against a ``torch.distributed.device_mesh.
DeviceMesh`` or against a plain ``{axis: size}`` mapping (the production
sizes, with no devices). :func:`placements` turns a spec into DTensor
placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Tuple

from ..utils import tree

PyTree = Any

# path-suffix -> rule name
_RULES: Tuple[Tuple[str, str], ...] = (
    (r"embed/w$", "emb"),
    (r"lm_head/w$", "emb_t"),
    (r"moe/router$", "repl"),
    (r"moe/w_(gate|up)$", "exp_col"),
    (r"moe/w_down$", "exp_row"),
    (r"shared/w_(gate|up)$", "col"),
    (r"shared/w_down$", "row"),
    (r"(attn/w[qkv]|attn/q_a|attn/q_b|attn/kv_a|attn/kv_b)$", "col"),
    (r"attn/wo$", "row"),
    (r"mlp/w_(gate|up)$", "col"),
    (r"mlp/w_down$", "row"),
    (r"mamba/(in_proj|dt_proj)$", "col"),
    (r"mamba/(out_proj|x_proj)$", "row"),
    (r"mamba/conv_w$", "conv"),
    (r"mamba/(a_log|d_skip)$", "inner_vec"),
    (r"tmix/(wr|wk|wv|wg|maa_w1|decay_w1)$", "col"),
    (r"tmix/(wo|maa_w2|decay_w2)$", "row_last2"),
    (r"cmix/(wk|wr)$", "col"),
    (r"cmix/wv$", "row"),
)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh)


def _fits(dim: int, sizes: Dict[str, int], axes) -> bool:
    if axes is None:
        return True
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    size = 1
    for n in names:
        size *= sizes[n]
    return dim % size == 0


def _entry(axes):
    """A one-name tuple is the name and an empty one None, as in
    ``PartitionSpec``."""
    if isinstance(axes, tuple) and len(axes) <= 1:
        return axes[0] if axes else None
    return axes


def _guard(shape, sizes: Dict[str, int], spec_dims) -> tuple:
    """Drop any axis that does not divide its dimension."""
    return tuple(_entry(axes) if _fits(dim, sizes, axes) else None
                 for dim, axes in zip(shape, spec_dims))


def path_of(path) -> str:
    return tree.path_str(path)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec resolved against a mesh (a leaf of the ``*_shardings``
    trees, as JAX's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    def placements(self):
        return placements(self.spec, self.mesh)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: per
    mesh dimension, ``Shard(d)`` for the tensor dimension ``d`` whose
    entry names that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, axes in enumerate(spec) if axes is not None
                    and name in ((axes,) if isinstance(axes, str)
                                 else axes)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


class ShardingRules:
    """Resolves partition specs against a mesh.

    data_axis: FSDP/weight-sharding axis name; model_axis: TP axis;
    batch_axes: axes used for the batch dim of activations/inputs
    (('pod', 'data') on the multi-pod mesh).
    """

    def __init__(self, mesh, data_axis: str = "data",
                 model_axis: str = "model", fsdp: bool = True):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.fsdp = fsdp
        self.batch_axes = tuple(n for n in ("pod", "data")
                                if n in self.sizes)

    def _named(self, spec: tuple) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    # ---------------------------------------------------------- params -----
    def _rule_spec(self, rule: str, shape) -> tuple:
        d, m = (self.data_axis if self.fsdp else None), self.model_axis
        lead = len(shape) - 2
        if rule in ("exp_col", "exp_row"):
            lead = len(shape) - 3
        pre = (None,) * max(lead, 0)
        g = lambda dims: _guard(shape, self.sizes, dims)  # noqa: E731
        if rule == "col":
            return g(pre + (d, m))
        if rule == "row":
            return g(pre + (m, d))
        if rule == "row_last2":
            return g(pre + (m, None))
        if rule == "exp_col":
            return g(pre + (m, d, None))
        if rule == "exp_row":
            return g(pre + (m, None, d))
        if rule == "emb":
            return g((m, d))
        if rule == "emb_t":
            return g((d, m))
        if rule == "conv":
            return g(pre + (None, m))
        if rule == "inner_vec":
            # a_log (..., d_inner, d_state): shard d_inner;
            # d_skip (..., d_inner)
            if len(shape) >= 2 and shape[-1] < shape[-2]:
                return g((None,) * (len(shape) - 2) + (m, None))
            return g((None,) * (len(shape) - 1) + (m,))
        return ()

    def param_rule(self, path_str: str) -> str:
        for pat, rule in _RULES:
            if re.search(pat, path_str):
                return rule
        return "repl"

    def param_spec(self, path_str: str, shape) -> tuple:
        return self._rule_spec(self.param_rule(path_str), tuple(shape))

    def params_shardings(self, params: PyTree) -> PyTree:
        leaves, treedef = tree.tree_flatten_with_path(params)
        return treedef.unflatten([
            self._named(self.param_spec(path_of(p), x.shape))
            for p, x in leaves])

    # -------------------------------------------------- optimizer states ---
    def galore_state_shardings(self, params: PyTree,
                               opt_state: PyTree) -> PyTree:
        """GaLore/Adam states inherit the ambient-dim sharding of their
        block: for a COL block (d_in, d_out) with right basis (d_out, r),
        the basis shards d_out over model; projected (d_in, r) buffers
        shard d_in over fsdp. Dense moments mirror the param spec. Scalars
        (the step count and seed, host ints here) replicate."""
        from ..core.galore import DenseMoments, GaloreBlockState, GaloreState

        param_leaves = tree.tree_flatten_with_path(params)[0]
        g = lambda shape, dims: _guard(shape, self.sizes, dims)  # noqa: E731

        def shard_states(opt):
            if not isinstance(opt, GaloreState):
                # generic states (clip, weight decay, the lr count)
                return tree.tree_map(lambda x: self._named(()), opt)
            blk_leaves, treedef = tree.tree_flatten(
                opt.blocks, is_leaf=lambda x: isinstance(
                    x, (GaloreBlockState, DenseMoments)))
            out = []
            for (pth, leaf), st in zip(param_leaves, blk_leaves):
                spec = self.param_spec(path_of(pth), leaf.shape)
                dims = list(spec) + [None] * (leaf.ndim - len(spec))
                if isinstance(st, GaloreBlockState):
                    lead = tuple(dims[:-2])
                    row_ax, col_ax = dims[-2], dims[-1]
                    right = (st.m.shape[-1] == st.basis.shape[-1]
                             and st.m.shape[-2] == leaf.shape[-2])
                    if right:
                        basis_spec = g(st.basis.shape, lead + (col_ax, None))
                        buf_spec = g(st.m.shape, lead + (row_ax, None))
                    else:
                        basis_spec = g(st.basis.shape, lead + (row_ax, None))
                        buf_spec = g(st.m.shape, lead + (None, col_ax))
                    out.append(GaloreBlockState(
                        basis=self._named(basis_spec),
                        m=self._named(buf_spec), v=self._named(buf_spec)))
                else:
                    out.append(DenseMoments(
                        m=self._named(g(st.m.shape, dims[:st.m.ndim])),
                        v=self._named(g(st.v.shape, dims[:st.v.ndim]))))
            return GaloreState(count=self._named(()), seed=self._named(()),
                               blocks=treedef.unflatten(out))

        if isinstance(opt_state, tuple) and not hasattr(opt_state,
                                                        "_fields"):
            return tuple(shard_states(s) for s in opt_state)
        return shard_states(opt_state)

    # ------------------------------------------------------- activations ---
    def batch_spec(self, shape) -> tuple:
        """Inputs (B, ...): shard batch over (pod, data) when divisible."""
        return _guard(shape, self.sizes,
                      (self.batch_axes,) + (None,) * (len(shape) - 1))

    def data_shardings(self, batch: PyTree) -> PyTree:
        return tree.tree_map(
            lambda x: self._named(self.batch_spec(x.shape)), batch)

    # ---------------------------------------------------- decode states ----
    def decode_state_shardings(self, state: PyTree) -> PyTree:
        """Decode-state layout: KV caches (nb, B, S, ...) shard batch over
        (pod, data) and the cache slots over model (flash-decoding-style
        sequence parallelism: the attention contraction over slots
        reduces per-shard softmax statistics instead of gathering the
        cache). Recurrent states (no slot dim) shard batch over (pod,
        data) and their largest trailing dim that the model axis divides
        over model."""
        sizes, m = self.sizes, self.model_axis

        def one(leaf):
            shape = tuple(leaf.shape)
            dims = [None] * len(shape)
            if len(shape) >= 2:
                batch_dim = 1
                if _fits(shape[batch_dim], sizes, self.batch_axes):
                    dims[batch_dim] = _entry(self.batch_axes)
                # cache slots (dim 2 of (nb, B, S, ...)) over model; the
                # pos buffer (nb, B, S) follows the same slot sharding
                if len(shape) >= 3 and shape[2] % sizes[m] == 0 \
                        and shape[2] >= sizes[m]:
                    dims[2] = m
                else:
                    # recurrent state: largest trailing dim over model
                    for cand in range(len(shape) - 1, batch_dim, -1):
                        if dims[cand] is None and \
                                shape[cand] % sizes[m] == 0 and \
                                shape[cand] >= sizes[m]:
                            dims[cand] = m
                            break
            return self._named(tuple(dims))

        return tree.tree_map(one, state)
