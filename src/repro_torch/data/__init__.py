"""Synthetic federated data (the port's own copy of the slice of
``repro/data`` the FedGaLore round uses: ``seq_classification``, the
Dirichlet partition and ``FederatedBatcher``). The copy makes the same
numpy calls in the same order, so the batches are identical to the JAX
package's for the same seeds."""
from .partition import dirichlet_label_partition, iid_partition
from .pipeline import FederatedBatcher
from .synthetic import TaskData, seq_classification

__all__ = ["dirichlet_label_partition", "iid_partition", "FederatedBatcher",
           "TaskData", "seq_classification"]
