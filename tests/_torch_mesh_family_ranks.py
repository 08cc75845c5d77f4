"""Per-rank body of ``tests/test_torch_mesh_families.py``.

``distributed.run_local`` pickles it by import path and the spawned ranks
import this module, so it imports only torch and the port.  Each rank
builds the configs' fp32 params from a seed (the same tensors in every
process; packed where the config is binary), runs the port's mesh serve
steps and returns numpy arrays.
"""
import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.sharding import placement as pl


def params_of(cfg, seed: int = 0):
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    if cfg.quant.mode == "binary":
        params = api.binarize_model_params(cfg, params)
    return params


def recording_matmul(calls: list):
    """``ops.binary_matmul`` that keeps the shapes of each call's rows and
    packed weight, and raises if it is handed a DTensor."""
    real = ops.binary_matmul

    def wrapped(x, B_packed, alpha, **kw):
        if pl.is_dtensor(x) or pl.is_dtensor(B_packed) or pl.is_dtensor(alpha):
            raise AssertionError("the kernel wrapper got a DTensor")
        calls.append((tuple(x.shape), tuple(B_packed.shape)))
        return real(x, B_packed, alpha, **kw)
    return wrapped


def recording_route(ids: list):
    """``moe.route`` that keeps the expert ids of each call."""
    real = moe.route

    def route(params, x, cfg):
        out = real(params, x, cfg)
        ids.append(out[2].numpy().copy())
        return out
    return route


def run_serve(cfg, mesh, batch_np, prompt_np, ids: list) -> dict:
    """One decode step and one prefill forward (``prompt_np``: its batch)
    of ``cfg`` on ``mesh``: the logits, the cache after the step, the
    expert ids each MoE call routed and the shapes of each kernel call."""
    real, real_mm, calls = moe.route, ops.binary_matmul, []
    moe.route, ops.binary_matmul = recording_route(ids), recording_matmul(calls)
    try:
        step = steps.build_serve_step(cfg, mesh)
        params = step.shard_params(params_of(cfg))
        logits, cache = step(params, step.shard_batch(params_from_numpy(batch_np, device="cpu")))
        decode_ids, decode_calls = list(ids), list(calls)
        ids.clear()
        calls.clear()
        pre = steps.build_serve_step(cfg, mesh, kind="prefill")
        prefill = pre(pre.shard_params(params_of(cfg)),
                      pre.shard_batch(params_from_numpy(prompt_np, device="cpu")))
    finally:
        moe.route, ops.binary_matmul = real, real_mm
    return {"decode": pl.full(logits).numpy(), "prefill": pl.full(prefill).numpy(),
            "cache": cm.tree_map(lambda t: pl.full(t).numpy(), cache),
            "decode_ids": decode_ids, "prefill_ids": list(ids),
            "decode_calls": decode_calls, "prefill_calls": list(calls)}


def serve(rank, world, cases):
    """Each case ``(name, cfg, n_model, batch, prompt)`` on a
    ``(world / n_model) x n_model`` mesh."""
    torch.set_num_threads(1)
    out = {}
    for name, cfg, n_model, batch_np, prompt_np in cases:
        out[name] = run_serve(cfg, lmesh.make_host_mesh(n_model, device="cpu"), batch_np,
                              prompt_np, [])
    return out
