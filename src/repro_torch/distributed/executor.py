"""execute_sharded(): run one BinArrayProgram forward across the ranks of a mesh.

Port of ``repro/distributed/executor.py``, over ``torch.distributed`` in
place of ``shard_map``.  Every rank of the mesh calls it with the same
global batch and gets the same global logits back.  It is bit-exact
against ``deploy.execute`` for every §IV-D schedule, because nothing
numeric changes:

  * data parallelism splits the batch: rank ``r`` sits at mesh coordinate
    ``(r // n_model, r % n_model)`` and runs the contiguous rows of its
    data coordinate.  Each kernel computes an output row from that row's
    input alone, so a rank's rows equal the same rows of the whole batch;
  * a bd-sharded conv runs ``binary_conv`` on the rank's output-channel
    slice with the shard's frozen device-local plan, then ``all_gather``
    over the mesh's ``model`` group concatenates the slices in channel
    order, with no reduction;
  * replicated layers run ``deploy.executor._apply`` verbatim;
  * the logits are gathered over the ``data`` group, so every rank holds
    ``[B, classes]``, as the JAX function returns a global array.

A global batch not divisible by ``n_data`` gets zero images appended and
the same rows sliced back.  Every kernel call passes a frozen plan, so the
forward makes no plan pick (``kernels.ops.plan_pick_count``).

A rank's channel slices of a bd layer (packed taps, alpha, bias) are cut
once per (program, plan) and made contiguous: the conv launcher takes
contiguous tensors whose packed bytes start on a 4-byte boundary, which a
strided view of the whole layer is not.  They are cached as the JAX
package caches its per-layer modules; :func:`cache_stats` /
:func:`cache_gauges` report the cache's size, flat after warm-up.  The port
traces nothing, so the JAX package's ``trace_entry_count`` has no
counterpart.

A 1x1 plan runs in one process with no process group.  A larger plan needs
an initialized group of exactly ``plan.devices`` ranks.  The backend is the
caller's: ``"nccl"`` where every rank has its own card, ``"gloo"`` for
several ranks on one card or on the CPU.  A failed collective raises; it is
never caught and retried another way.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist

from repro_torch.deploy import executor as dexec
from repro_torch.deploy.program import BinArrayProgram
from repro_torch.distributed.plan import MeshPlan
from repro_torch.distributed.stats import _check_arity

# program -> {(plan, model coordinate): (local ConvInstr | None per instruction)}
_bound: "weakref.WeakKeyDictionary[BinArrayProgram, dict]" = weakref.WeakKeyDictionary()
# (n_data, n_model, axis names, device type) -> DeviceMesh over this process's group
_meshes: dict = {}


def _bound_count() -> int:
    return sum(sum(i is not None for i in instrs)
               for per in _bound.values() for instrs in per.values())


def cache_stats() -> dict:
    """The executor's cached state as numbers: ``local_instrs``, the bd
    channel slices bound (one per bd layer per (program, plan, model
    coordinate)), and ``meshes``, the DeviceMeshes built by
    ``execute_sharded`` itself."""
    return {"local_instrs": _bound_count(), "meshes": len(_meshes)}


def cache_gauges() -> dict:
    """``name -> callable`` gauges for ``testing/soak.py``, exactly flat once
    a workload has seen all its plans."""
    return {"dist_local_instrs": lambda: float(_bound_count()),
            "dist_meshes": lambda: float(len(_meshes))}


def _local_instrs(program: BinArrayProgram, plan: MeshPlan, col: int) -> tuple:
    """Per instruction: the rank's bd slice (contiguous, with the shard's
    plan), or None for a replicated layer."""
    per = _bound.setdefault(program, {})
    key = (plan, col)
    if key not in per:
        local = []
        for instr, s in zip(program.instrs, plan.shards):
            if s.kind != "bd":
                local.append(None)
                continue
            d0, d1 = col * s.d_local, (col + 1) * s.d_local
            local.append(dataclasses.replace(
                instr, B_tap_packed=instr.B_tap_packed[..., d0:d1].contiguous(),
                alpha=instr.alpha[..., d0:d1].contiguous(),
                bias=instr.bias[d0:d1].contiguous(), plan=s.plan))
        per[key] = tuple(local)
    return per[key]


def _mesh(plan: MeshPlan, device_type: str):
    key = (plan.n_data, plan.n_model, plan.axis_data, plan.axis_model, device_type)
    if key not in _meshes:
        _meshes[key] = plan.build_mesh(device_type)
    return _meshes[key]


def _gather(y: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def execute_sharded(program: BinArrayProgram, plan: MeshPlan, x: torch.Tensor,
                    m_active=None, *, mesh=None) -> torch.Tensor:
    """Run the program on a global batch across the mesh: x [B, H, W, C] ->
    logits [B, classes] on every rank.

    ``m_active`` takes every §IV-D schedule form ``deploy.execute`` does
    (None | int | per-instruction sequence).  ``mesh`` is a DeviceMesh of
    shape ``(n_data, n_model)`` to run on; by default the one
    ``plan.build_mesh`` makes over the initialized group, built once per
    mesh shape and device type.  Every rank must call this with the same
    arguments.
    """
    dexec._check_input(program, x)
    _check_arity(program, plan, " — re-plan with plan_mesh(program, ...)")
    sched = program.resolve_schedule(m_active)
    if plan.devices == 1:
        c_data = c_model = 0
        g_data = g_model = None
    else:
        if mesh is None:
            mesh = _mesh(plan, program.device.type)
        if tuple(mesh.shape) != (plan.n_data, plan.n_model):
            raise ValueError(f"mesh of shape {tuple(mesh.shape)} for a "
                             f"{plan.n_data}x{plan.n_model} MeshPlan")
        c_data, c_model = mesh.get_coordinate()
        g_data, g_model = mesh.get_group(plan.axis_data), mesh.get_group(plan.axis_model)
    local = _local_instrs(program, plan, c_model)
    B = x.shape[0]
    pad = (-B) % plan.n_data
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    rows = x.shape[0] // plan.n_data
    y = x[c_data * rows:(c_data + 1) * rows].to(torch.float32)
    for instr, m, s, loc in zip(program.instrs, sched, plan.shards, local):
        if loc is None:
            y = dexec._apply(instr, y, m)
            continue
        y = dexec._apply(loc, y, m)
        if plan.n_model > 1:
            # disjoint channel slices, concatenated in channel order
            y = _gather(y, g_model, plan.n_model, dim=-1)
    if plan.n_data > 1:
        y = _gather(y, g_data, plan.n_data, dim=0)
    return y[:B] if pad else y
