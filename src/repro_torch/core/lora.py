"""LoRA parameterization and factor algebra (port of ``repro/core/lora.py``;
paper §4.1 and the baselines).

A LoRA-adapted block is ``W = W0 + (alpha/r) * B A`` with ``A ∈ R^{r×n}``
(Gaussian init) and ``B ∈ R^{m×r}`` (zero init). The federated baselines
differ in which factors train and how they aggregate:

  FedIT      — avg A and B separately:  ΔW̄ = (Σ p̃ᵢ Bᵢ)(Σ p̃ᵢ Aᵢ)   (rank ≤ r)
  FFA-LoRA   — A frozen at A0:          ΔW̄ = (Σ p̃ᵢ Bᵢ) A0          (rank ≤ r)
  LoRA-Fair  — factor avg + server refinement toward the mean lift
  FLoRA      — lift:                    ΔW̄ = Σ p̃ᵢ Bᵢ Aᵢ            (rank ≤ Kr)
  FR-LoRA    — lift + residual carry-over into re-initialized factors

The rank-tail diagnostic (Eq. 10) measures the off-manifold component
``dist_F(ΔW̄, M_{≤r}) = sqrt(Σ_{j>r} σ_j²)`` that drives update-space
mismatch.

The A draw is JAX's: ``0.02·normal(fold_in(key, i), (*lead, r, n))`` on
the port's threefry (``utils.prng``, one ulp from ``jax.random.normal``),
``i`` the leaf's index in JAX's flatten order. :func:`svd_truncate` takes
its SVD from ``core.projector``, LAPACK ``gesdd`` through SciPy on the
CPU, so its factors carry JAX's signs there.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import projector as proj
from ..utils import prng, tree

PyTree = Any


class LoraPair(NamedTuple):
    a: torch.Tensor   # (..., r, n)
    b: torch.Tensor   # (..., m, r)


def lora_init(key: torch.Tensor, shape, rank: int, dtype=torch.float32,
              a_std: float = 0.02) -> LoraPair:
    """Adapters for a (m, n) block or a stacked (nb, m, n) scan-block leaf
    (one adapter per layer, leading dims broadcast through the factor
    algebra — ``b @ a`` is a batched matmul). The draw is float32, as
    JAX's is for the default dtype."""
    if dtype != torch.float32:
        raise ValueError(f"lora_init draws float32 adapters, got {dtype}")
    *lead, m, n = shape
    a = a_std * prng.normal(key, (*lead, rank, n))
    b = torch.zeros((*lead, m, rank), dtype=dtype, device=key.device)
    return LoraPair(a=a, b=b)


def lora_delta(pair: LoraPair, scale: float = 1.0) -> torch.Tensor:
    return scale * (pair.b @ pair.a)


def is_lora_pair(x) -> bool:
    return isinstance(x, LoraPair)


def tree_lora_init(key: torch.Tensor, params: PyTree, target_fn, rank: int,
                   dtype=torch.float32) -> PyTree:
    """LoraPair for each matrix target leaf — plain (m, n) or stacked
    (nb, m, n) scan-block layout — None elsewhere (the (2, 3)-D acceptance
    of ``fed.split_trainable``, so the LoRA baselines adapt the same target
    modules as the dense/GaLore methods). Leaf i draws from ``fold_in(key,
    i)`` on its own device."""
    leaves, treedef = tree.tree_flatten_with_path(params)
    out = []
    for i, (path, p) in enumerate(leaves):
        if p.ndim in (2, 3) and target_fn(tree.path_str(path), p):
            out.append(lora_init(prng.fold_in(key.to(p.device), i),
                                 tuple(p.shape),
                                 min(rank, min(p.shape[-2:])), dtype))
        else:
            out.append(None)
    return treedef.unflatten(out)


def apply_lora(params: PyTree, adapters: PyTree, scale: float = 1.0
               ) -> PyTree:
    """Effective weights W0 + scale·BA (None adapters pass through)."""
    def merge(p, ad):
        if ad is None:
            return p
        return p + lora_delta(ad, scale).to(p.dtype)
    return tree.tree_map(merge, params, adapters,
                         is_leaf=lambda x: x is None or is_lora_pair(x))


# --------------------------------------------------------------- metrics ----

def rank_tail_energy(delta_w: torch.Tensor, rank: int) -> torch.Tensor:
    """Eckart–Young distance to the rank-≤r manifold (Eq. 10); batched over
    any leading dims."""
    s = torch.linalg.svdvals(delta_w)
    return torch.sqrt(torch.sum(s[..., rank:] ** 2, dim=-1))


def effective_rank(delta_w: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    s = torch.linalg.svdvals(delta_w)
    return torch.sum(s > tol * s[..., :1], dim=-1)


def svd_truncate(delta_w: torch.Tensor, rank: int) -> LoraPair:
    """Re-factorize a dense delta to rank-r LoRA factors (used by FR-LoRA and
    post-hoc SVD baselines); batched over any leading dims."""
    u, s, vt = proj._svd(delta_w)
    sq = torch.sqrt(s[..., :rank])
    return LoraPair(a=sq[..., :, None] * vt[..., :rank, :],
                    b=u[..., :, :rank] * sq[..., None, :])
