"""Per-device accounting of a program under a MeshPlan.

Port of ``repro/distributed/stats.py``: the compiler's
:class:`~repro_torch.deploy.program.LayerStats` grown by the mesh
dimension, i.e. how many bytes of packed weights, shared memory and gather
traffic each rank carries, split into replicated and sharded.

The keys are the JAX package's, with two exceptions:

  * ``per_device_vmem_bytes`` / ``max_per_device_vmem_bytes`` (the TPU's
    working set) become ``per_device_shared_bytes`` /
    ``max_per_device_shared_bytes``: ``binary_conv.shared_bytes`` of the
    device-local plan (bd) or of the instruction's plan (a replicated
    conv), 0 for the other kernels;
  * ``per_device_hbm_fused_bytes`` is left out: the port's ``LayerStats``
    records no HBM estimate.

``local_plan`` reads ``{"rows", "cols"}``, the port's conv plan.
Everything reads shapes and static fields only (abstract-program safe).
"""
from __future__ import annotations

import math

from repro_torch.deploy.program import BinArrayProgram, ConvInstr
from repro_torch.distributed.plan import MeshPlan
from repro_torch.kernels import binary_conv as bck


def _check_arity(program: BinArrayProgram, plan: MeshPlan, hint: str = "") -> None:
    if len(plan.shards) != len(program.instrs):
        raise ValueError(
            f"MeshPlan carries {len(plan.shards)} shard(s) for "
            f"{len(program.instrs)} instruction(s){hint}")


def shard_layer_stats(program: BinArrayProgram, plan: MeshPlan) -> list[dict]:
    """One JSON-able dict per instruction: its placement and per-rank byte
    split under ``plan``.  ``gather_bytes`` is the fp32 output traffic one
    rank receives per forward from the bd all_gather (0 for replicated
    layers, which communicate nothing)."""
    _check_arity(program, plan)
    out = []
    for idx, (instr, s) in enumerate(zip(program.instrs, plan.shards)):
        st = instr.stats
        bd = s.kind == "bd"
        row = {
            "index": idx, "name": instr.name, "kind": instr.kind,
            "shard": s.kind, "devices": plan.devices,
            "weight_bytes": int(st.weight_bytes),
            "per_device_weight_bytes": int(st.weight_bytes)
            // (plan.n_model if bd else 1),
        }
        if bd:
            row["d_local"] = s.d_local
            row["local_plan"] = {"rows": s.plan.rows, "cols": s.plan.cols}
            row["per_device_shared_bytes"] = bck.shared_bytes(s.plan, instr.M)
            # fp32 output rows received from the other model-axis peers
            recv = (math.prod(st.out_shape[1:]) * plan.local_batch * 4
                    * (plan.n_model - 1)) // plan.n_model
            row["gather_bytes"] = int(recv)
        else:
            row["per_device_shared_bytes"] = (
                bck.shared_bytes(instr.plan, instr.M)
                if isinstance(instr, ConvInstr) else 0)
            row["gather_bytes"] = 0
        out.append(row)
    return out


def mesh_totals(program: BinArrayProgram, plan: MeshPlan) -> dict:
    """Whole-program roll-up of :func:`shard_layer_stats`.

    ``replication_overhead`` is fleet weight bytes (every copy on every
    rank) over one program copy: ``devices`` when everything is
    replicated, shrinking toward ``n_data`` as layers shard.
    """
    rows = shard_layer_stats(program, plan)
    single = sum(r["weight_bytes"] for r in rows)
    fleet = sum(r["weight_bytes"] * (plan.n_data if r["shard"] == "bd" else plan.devices)
                for r in rows)
    return {
        "devices_per_forward": plan.devices,
        "n_data": plan.n_data,
        "n_model": plan.n_model,
        "global_batch": plan.global_batch,
        "local_batch": plan.local_batch,
        "sharded_layers": sum(1 for r in rows if r["shard"] == "bd"),
        "per_device_weight_bytes": int(sum(r["per_device_weight_bytes"] for r in rows)),
        "replicated_weight_bytes": int(sum(
            r["weight_bytes"] for r in rows if r["shard"] != "bd")),
        "sharded_weight_bytes": int(sum(
            r["weight_bytes"] for r in rows if r["shard"] == "bd")),
        "max_per_device_shared_bytes": int(max(
            r["per_device_shared_bytes"] for r in rows)),
        "gather_bytes": int(sum(r["gather_bytes"] for r in rows)),
        "replication_overhead": (fleet / single) if single else 0.0,
    }
