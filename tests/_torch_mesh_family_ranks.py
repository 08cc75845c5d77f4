"""Per-rank body of ``tests/test_torch_mesh_families.py``.

``distributed.run_local`` pickles it by import path and the spawned ranks
import this module, so it imports only torch and the port.  Each rank
builds the configs' fp32 params from a seed (the same tensors in every
process), runs the port's mesh serve steps and returns numpy arrays.
"""
import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models import moe
from repro_torch.sharding import placement as pl


def params_of(cfg, seed: int = 0):
    return api.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def recording_route(ids: list):
    """``moe.route`` that keeps the expert ids of each call."""
    real = moe.route

    def route(params, x, cfg):
        out = real(params, x, cfg)
        ids.append(out[2].numpy().copy())
        return out
    return route


def run_serve(cfg, mesh, batch_np, prompt_np, ids: list) -> dict:
    """One decode step and one prefill forward of ``cfg`` on ``mesh``: the
    logits, and the expert ids each MoE call routed."""
    real = moe.route
    moe.route = recording_route(ids)
    try:
        step = steps.build_serve_step(cfg, mesh)
        params = step.shard_params(params_of(cfg))
        logits, _ = step(params, step.shard_batch(params_from_numpy(batch_np, device="cpu")))
        decode_ids = list(ids)
        ids.clear()
        pre = steps.build_serve_step(cfg, mesh, kind="prefill")
        prefill = pre(pre.shard_params(params_of(cfg)),
                      pre.shard_batch({"tokens": torch.from_numpy(prompt_np)}))
    finally:
        moe.route = real
    return {"decode": pl.full(logits).numpy(), "prefill": pl.full(prefill).numpy(),
            "decode_ids": decode_ids, "prefill_ids": list(ids)}


def serve(rank, world, cases):
    """Each case ``(name, cfg, n_model, batch, prompt)`` on a
    ``(world / n_model) x n_model`` mesh."""
    torch.set_num_threads(1)
    out = {}
    for name, cfg, n_model, batch_np, prompt_np in cases:
        out[name] = run_serve(cfg, lmesh.make_host_mesh(n_model, device="cpu"), batch_np,
                              prompt_np, [])
    return out
