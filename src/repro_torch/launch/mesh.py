"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module constants, so importing touches no process group.
Single-pod: 16x16 = 256 devices (data, model).  Multi-pod: 2x16x16 = 512
devices (pod, data, model); the 'pod' axis is the slow inter-pod domain, on
which the sharding rules place only DP/FSDP traffic.  Both build a
``DeviceMesh`` over the initialized process group, whose world must be the
mesh's size: torch has no device mesh without ranks, so the rules of a mesh
that is not there are computed from its axis sizes instead
(``sharding/rules.py`` takes a ``{axis: size}`` mapping).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device

PRODUCTION_AXES = {False: (("data", "model"), (16, 16)),
                   True: (("pod", "data", "model"), (2, 16, 16))}


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    names, shape = PRODUCTION_AXES[multi_pod]
    return _mesh(device, shape, names)


def _mesh(device, shape, names):
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_host_mesh(model_axis: int = 1, *, device="cuda"):
    """A ``(world // model_axis, model_axis)`` (data, model) mesh over the
    ranks of the initialized process group (tests / one-host runs)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or distributed.run_local)")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the world of {n} ranks")
    return _mesh(device, (n // model_axis, model_axis), ("data", "model"))
