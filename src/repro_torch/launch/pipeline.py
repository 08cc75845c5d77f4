"""Optional pipeline parallelism: a GPipe-style microbatch pipeline on a
'pipe' mesh axis (port of ``repro/launch/pipeline.py``).

Composable with the (data, model) mesh: stages hold contiguous layer blocks;
microbatches stream through stages with one ring step per tick (fill +
steady-state + drain = n_micro + n_stages - 1 ticks).  The JAX package's
``shard_map`` + ``ppermute`` become, on each rank of the ``pipe`` group, a
loop over the ticks with one ``send``/``recv`` pair to the next and from the
previous stage, and its closing ``psum`` an ``all_reduce``: every rank
returns the last stage's outputs (the other stages contribute zeros).  A
``gloo`` group moves host memory, so with gloo a card tensor crosses the
ring through the host.

This module is self-contained (a per-stage fn over stacked stage params),
so the mainline FSDP/TP path stays pipeline-free; it proves the schedule
computes what ``reference_apply`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device
from repro_torch.models.common import tree_leaves, tree_map


def make_pipeline_mesh(n_pipe: int, n_data: int = 1, *, device="cuda"):
    """A ``(n_pipe, n_data)`` ("pipe", "data") mesh over the initialized
    process group, which must hold ``n_pipe * n_data`` ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_pipe * n_data:
        raise ValueError(f"a {n_pipe}x{n_data} pipeline mesh needs {n_pipe * n_data} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(resolve_device(device).type, (n_pipe, n_data),
                            mesh_dim_names=("pipe", "data"))


def _ring_step(h: torch.Tensor, group, stage: int, n_stages: int) -> torch.Tensor:
    """Send ``h`` to the next stage, receive the previous stage's."""
    if n_stages == 1:
        return h
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    host = dist.get_backend(group) == "gloo" and h.device.type != "cpu"
    out = torch.empty_like(h, device="cpu" if host else h.device)
    ops = [dist.P2POp(dist.isend, h.cpu() if host else h.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(h.device)


def pipeline_apply(stage_fn, params_stacked, x: torch.Tensor, *, mesh, n_micro: int):
    """y = stage_{S-1}(...stage_0(x)) with stages spread over 'pipe'.

    stage_fn(stage_params, h) -> h'
    params_stacked: tree with leading dim n_stages; rank ``s`` of the pipe
    axis runs stage ``s``.
    x: [B, ...] with B % n_micro == 0; batch microbatched and streamed.
    Every rank of the mesh calls this with the same arguments and gets y.
    """
    n_stages = mesh.shape[mesh.mesh_dim_names.index("pipe")]
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    if tree_leaves(params_stacked)[0].shape[0] != n_stages:
        raise ValueError(f"params stack {tree_leaves(params_stacked)[0].shape[0]} stages, "
                         f"the pipe axis has {n_stages}")
    mb = B // n_micro
    group = mesh.get_group("pipe")
    stage = mesh.get_local_rank("pipe")
    stage_params = tree_map(lambda t: t[stage], params_stacked)
    mbs = x.reshape(n_micro, mb, *x.shape[1:])
    buf = torch.zeros_like(mbs[0])
    outs = torch.zeros_like(mbs)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (if in range)
        h = stage_fn(stage_params, mbs[t] if stage == 0 and t < n_micro else buf)
        # last stage emits microbatch (t - (n_stages - 1))
        emit = t - (n_stages - 1)
        if stage == n_stages - 1 and emit >= 0:
            outs[emit] = h
        # rotate activations downstream: stage i -> stage i+1
        buf = _ring_step(h, group, stage, n_stages)
    # only the last stage holds real outputs: zero elsewhere + psum
    dist.all_reduce(outs, group=group)
    return outs.reshape(B, *x.shape[1:])


def reference_apply(stage_fn, params_stacked, x: torch.Tensor) -> torch.Tensor:
    """Unpipelined ground truth: apply stages sequentially."""
    h = x
    for i in range(tree_leaves(params_stacked)[0].shape[0]):
        h = stage_fn(tree_map(lambda t: t[i], params_stacked), h)
    return h
