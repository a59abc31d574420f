"""Synthetic federated data (the port's own copy of ``repro/data``: the
three synthetic tasks, the Dirichlet and IID partitions with their
heterogeneity diagnostics, and ``FederatedBatcher``). The copy makes the
same numpy calls in the same order, so the arrays and batches are
identical to the JAX package's for the same seeds."""
from .partition import (dirichlet_label_partition, heterogeneity_stats,
                        iid_partition)
from .pipeline import FederatedBatcher
from .synthetic import (TaskData, accuracy_from_logits, markov_lm,
                        patch_classification, seq_classification)

__all__ = [
    "dirichlet_label_partition", "heterogeneity_stats", "iid_partition",
    "FederatedBatcher", "TaskData", "accuracy_from_logits", "markov_lm",
    "patch_classification", "seq_classification",
]
