"""Logical-axis sharding rules and the reference's production meshes
(counterpart of ``repro.parallel``).  On one card nothing is sharded: the
rules only reckon what each leaf's sharding would be on a described mesh."""
from .mesh import make_local_mesh, make_production_mesh
from .sharding import LogicalRules, logical_to_spec, make_rules, shard

__all__ = [
    "LogicalRules",
    "logical_to_spec",
    "make_local_mesh",
    "make_production_mesh",
    "make_rules",
    "shard",
]
