"""Multi-device BinArrayProgram execution (paper §IV scaled to a mesh).

Port of ``repro.distributed`` over ``torch.distributed``: ``plan_mesh``
freezes a :class:`MeshPlan` (data-parallel batch, and an output-channel
model split per layer where it pays), ``execute_sharded`` runs one forward
across the ranks of the mesh bit-exact against ``deploy.execute``, and
``shard_layer_stats`` / ``mesh_totals`` account the per-rank byte splits.
``run_local`` spawns a small mesh of ranks on this host.

Names of the JAX package without a counterpart: ``interpret`` (the port
has no interpret mode) and ``trace_entry_count`` /
``reset_trace_entry_count`` (the port traces nothing; ``cache_stats`` and
``cache_gauges`` count the bound channel slices instead).
"""
from repro_torch.distributed.executor import cache_gauges, cache_stats, execute_sharded
from repro_torch.distributed.local import run_local
from repro_torch.distributed.plan import (DATA_AXIS, DEFAULT_MIN_SHARD_BYTES, MODEL_AXIS,
                                          LayerShard, MeshPlan, plan_mesh)
from repro_torch.distributed.stats import mesh_totals, shard_layer_stats

__all__ = [
    "DATA_AXIS", "DEFAULT_MIN_SHARD_BYTES", "MODEL_AXIS",
    "LayerShard", "MeshPlan", "plan_mesh",
    "execute_sharded", "cache_stats", "cache_gauges", "run_local",
    "shard_layer_stats", "mesh_totals",
]
