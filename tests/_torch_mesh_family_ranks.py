"""Per-rank body of ``tests/test_torch_mesh_families.py``.

``distributed.run_local`` pickles it by import path and the spawned ranks
import this module, so it imports only torch and the port.  Each rank
builds the configs' fp32 params from a seed (the same tensors in every
process; packed where the config is binary), runs the port's mesh serve
steps, trains the train configs from a seed, and returns numpy arrays.
"""
import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models import ssm as ssm_mod
from repro_torch.optim import sgd
from repro_torch.sharding import placement as pl

TRAIN_STEPS, BATCH, SEQ, LR = 2, 4, 8, 0.5


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


def recording_scan(scans: list):
    """``ssm.ssd_chunked`` and ``ssm.recurrent_step`` wrapped to keep, per
    call, its name, whether any argument was a DTensor, and the shapes of
    its x (the scan's ``[b, l, h, p]``, the update's ``[b, h, p]``) and its
    B (``[b, l, g, n]``, ``[b, h, n]``); returns the originals."""
    real = (ssm_mod.ssd_chunked, ssm_mod.recurrent_step)

    def wrap(name, fn, x_at, b_at):
        def wrapped(*args, **kw):
            scans.append((name, any(pl.is_dtensor(a) for a in args), tuple(args[x_at].shape),
                          tuple(args[b_at].shape)))
            return fn(*args, **kw)
        return wrapped
    ssm_mod.ssd_chunked = wrap("ssd", real[0], 0, 3)
    ssm_mod.recurrent_step = wrap("recurrent", real[1], 3, 4)
    return real


def optimizer():
    """SGD with momentum, as ``_torch_mesh_lm_ranks.optimizer`` (its
    docstring says why not AdamW)."""
    return sgd(LR)


def train(cfg, mesh):
    """TRAIN_STEPS steps from seed 0 on the synthetic batches (``mesh``
    None: single-process); the state and the losses."""
    opt = optimizer()
    state = steps.init_train_state(cfg, opt, device="cpu", mesh=mesh)
    step_fn = steps.build_train_step(cfg, opt, mesh=mesh)
    data, losses = SyntheticTokens(cfg.vocab, SEQ, BATCH, device="cpu"), []
    for _ in range(TRAIN_STEPS):
        state, met = step_fn(state, data.next_batch())
        losses.append(float(met["loss"]))
    return state, losses


def run_train(cfg, mesh) -> dict:
    """``cfg`` trained on ``mesh``: the losses, the params, and each SSM
    scan's record (``recording_scan``)."""
    scans = []
    real = recording_scan(scans)
    try:
        state, losses = train(cfg, mesh)
    finally:
        ssm_mod.ssd_chunked, ssm_mod.recurrent_step = real
    return {"losses": losses, "scans": scans,
            "params": cm.tree_map(lambda t: pl.full(t).numpy(), state["params"])}


def run_serve(cfg, mesh, batch_np, prompt_np, ids: list) -> dict:
    """One decode step and one prefill forward (``prompt_np``: its batch)
    of ``cfg`` on ``mesh``: the logits, the cache after the step, the
    expert ids each MoE call routed, the shapes of each kernel call and of
    each SSM scan and recurrent update."""
    real, real_mm, calls, scans = moe.route, ops.binary_matmul, [], []
    moe.route, ops.binary_matmul = recording_route(ids), recording_matmul(calls)
    real_scan = recording_scan(scans)
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
        ssm_mod.ssd_chunked, ssm_mod.recurrent_step = real_scan
    return {"decode": pl.full(logits).numpy(), "prefill": pl.full(prefill).numpy(),
            "cache": cm.tree_map(lambda t: pl.full(t).numpy(), cache),
            "decode_ids": decode_ids, "prefill_ids": list(ids),
            "decode_calls": decode_calls, "prefill_calls": list(calls), "scans": scans}


def serve(rank, world, cases, train_cfgs):
    """Each case ``(name, cfg, n_model, batch, prompt)`` on a
    ``(world / n_model) x n_model`` mesh, then each ``(name, cfg)`` of
    ``train_cfgs`` trained on a ``(world / 2) x 2`` mesh (under
    ``("train", name)``)."""
    torch.set_num_threads(1)
    out = {}
    for name, cfg, n_model, batch_np, prompt_np in cases:
        out[name] = run_serve(cfg, lmesh.make_host_mesh(n_model, device="cpu"), batch_np,
                              prompt_np, [])
    for name, cfg in train_cfgs:
        out["train", name] = run_train(cfg, lmesh.make_host_mesh(2, device="cpu"))
    return out
