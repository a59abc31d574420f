"""The federated runtime (port of ``repro/fedsim``)."""
from .runtime import ShardedFederation

__all__ = ["ShardedFederation"]
