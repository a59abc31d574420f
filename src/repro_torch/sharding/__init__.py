"""Partition specs for params, optimizer states, inputs and decode states
(port of ``repro/sharding``)."""
from .rules import NamedSharding, ShardingRules, path_of, placements

__all__ = ["NamedSharding", "ShardingRules", "path_of", "placements"]
