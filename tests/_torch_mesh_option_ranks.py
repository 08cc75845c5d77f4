"""Per-rank body of ``tests/test_torch_mesh_options.py``, and the helpers
its single-process references share.

``distributed.run_local`` pickles ``options`` by import path and the
spawned ranks import this module, so it imports only torch and the port.
Each rank builds reduced gemma's params from a seed (the same tensors in
every process), runs the mesh steps' options on the 2x1 and 1x2 meshes
of a world of 2 and returns numpy arrays.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import base as cb
from repro_torch.core import binlinear as bl
from repro_torch.core import compress as gc
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.launch import train as ltrain
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.optim import sgd
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding import placement as pl

BATCH, SEQ, LR, M = 4, 8, 0.5, 2
COMPRESSED_STEPS = 2
PROMPT = 16                     # the sequence-sharded prefill's tokens (B = 1)
RESUME_AT = 2                   # the compressed Trainer's checkpoint step


def config(mode: str = "dense"):
    return cb.reduced(cb.get_config("gemma_2b")).replace(
        dtype="float32", quant=bl.QuantConfig(mode=mode, M=M, K_iters=2))


def optimizer():
    """SGD with momentum (``_torch_mesh_lm_ranks.optimizer`` says why)."""
    return sgd(LR)


def data(batch: int = BATCH, seq: int = SEQ):
    return SyntheticTokens(config().vocab, seq, batch, device="cpu")


def numpy_tree(tree):
    return cm.tree_map(lambda t: pl.full(t).detach().numpy().copy(), tree)


def recording_compress(records: list):
    """``gc.compress_leaf`` that keeps, per call, the leaf's input
    ``g + e``, its reconstruction, residual and alphas (gathered whole)."""
    real = gc.compress_leaf

    def leaf(g, e, M):
        out = real(g, e, M)
        target = (pl.full(g).to(torch.float32) + pl.full(e)).numpy()
        records.append({"target": target, "recon": pl.full(out[0]).numpy().copy(),
                        "resid": pl.full(out[1]).numpy().copy(),
                        "alphas": out[2].numpy().copy()})
        return out
    return leaf


def train(cfg, mesh, *, n_steps: int, batch: int = BATCH, seq: int = SEQ,
          grad_compress_M: int = 0, microbatch=None, seq_sharded: bool = False) -> dict:
    """``n_steps`` steps of ``build_train_step`` from seed 0 (``mesh`` None:
    single-process): the losses, the params before and after, the error
    state and, with compression, each compressed leaf's record."""
    opt = optimizer()
    state = steps.init_train_state(cfg, opt, device="cpu", mesh=mesh)
    init = numpy_tree(state["params"])
    if grad_compress_M:
        state["grad_comp"] = gc.init_state(state["params"])
    fn = steps.build_train_step(cfg, opt, grad_compress_M=grad_compress_M, mesh=mesh,
                                microbatch=microbatch, seq_sharded=seq_sharded)
    src, losses, records, real = data(batch, seq), [], [], gc.compress_leaf
    gc.compress_leaf = recording_compress(records)
    try:
        for _ in range(n_steps):
            state, met = fn(state, src.next_batch())
            losses.append(float(met["loss"]))
    finally:
        gc.compress_leaf = real
    out = {"losses": losses, "init": init, "params": numpy_tree(state["params"]),
           "records": records}
    if grad_compress_M:
        out["error"] = numpy_tree(state["grad_comp"].error)
        out["error_placements"] = sorted({str(t.placements) for t in
                                          cm.tree_leaves(state["grad_comp"].error)
                                          if pl.is_dtensor(t)})
    return out


def prompt(cfg, batch: int = 1) -> torch.Tensor:
    return torch.randint(0, cfg.vocab, (batch, PROMPT), generator=torch.Generator()
                         .manual_seed(7), dtype=torch.int32)


def packed(cfg):
    return api.binarize_model_params(
        cfg, api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))


def prefill(cfg, mesh, *, seq_sharded: bool, batch: int = 1) -> dict:
    """The packed prefill forward (single-process when ``mesh`` is None):
    its logits and, per kernel call, the rows it got and its output."""
    params, tokens, calls = packed(cfg), prompt(cfg, batch), []
    real = ops.binary_matmul

    def rec(x, B_packed, alpha, **kw):
        y = real(x, B_packed, alpha, **kw)
        calls.append((tuple(x.shape), y.numpy().copy()))
        return y
    ops.binary_matmul = rec
    try:
        with torch.no_grad():
            if mesh is None:
                logits = api.forward(cfg, params, {"tokens": tokens})[0]
            else:
                step = steps.build_serve_step(cfg, mesh, kind="prefill",
                                              seq_sharded=seq_sharded)
                logits = step(step.shard_params(params), step.shard_batch({"tokens": tokens}))
    finally:
        ops.binary_matmul = real
    return {"logits": pl.full(logits).numpy(), "calls": calls}


def refuses_a_dividing_batch(cfg, mesh, batch: int) -> str:
    """A batch that divides the data axis (B = 2 at 2x1; any B at 1x2)
    with ``seq_sharded``: the residual's constraint names ``"data"``
    twice; the error's text, or '' if none."""
    try:
        prefill(cfg, mesh, seq_sharded=True, batch=batch)
    except ValueError as e:
        return str(e)
    return ""


def compressed_trainer(cfg, mesh, ckpt_dir: str, total: int):
    """A Trainer of compressed SGD steps from seed 1 (single-process when
    ``mesh`` is None), checkpointing at RESUME_AT."""
    opt = optimizer()
    state = steps.init_train_state(cfg, opt, seed=1, device="cpu", mesh=mesh)
    state["grad_comp"] = gc.init_state(state["params"])
    return Trainer(steps.build_train_step(cfg, opt, grad_compress_M=M, mesh=mesh), state, data(),
                   TrainerConfig(total_steps=total, checkpoint_every=RESUME_AT,
                                 checkpoint_dir=ckpt_dir, log_every=1000),
                   state_shardings=None if mesh is None else steps.train_state_shardings(
                       cfg, mesh, opt, grad_compress_M=M))


def resume(cfg, mesh, ckpt_dir: str) -> dict:
    """A compressed run's checkpoint (written single-process) resumed onto
    ``mesh``: the restored error state, where it was placed, and the loss
    of the step taken after it."""
    tr = compressed_trainer(cfg, mesh, ckpt_dir, RESUME_AT + 1)
    resumed = tr.maybe_resume() and tr.report.resumed_from
    err = tr.state["grad_comp"].error
    placed = all(pl.is_dtensor(e) and e.placements == p.placements for e, p in
                 zip(cm.tree_leaves(err), cm.tree_leaves(tr.state["params"])))
    restored = numpy_tree(err)
    report = tr.run()
    return {"resumed_from": resumed, "error": restored, "placed": placed,
            "losses": report.losses, "step": int(tr.state["step"])}


LAUNCH_ARGS = ("--arch", "gemma_2b", "--reduced", "--steps", "2", "--batch", str(BATCH),
               "--seq", str(SEQ), "--device", "cpu", "--grad-compress-M", str(M))


def launcher(ckpt_dir: str) -> list:
    """``launch/train.py``'s ``main`` with ``WORLD_SIZE`` set, compressed."""
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    try:
        report = ltrain.main([*LAUNCH_ARGS, "--checkpoint-dir", ckpt_dir])
    finally:
        del os.environ["WORLD_SIZE"]
    dist.barrier()
    return report.losses


def options(rank, world, ckpt_dir: str) -> dict:
    """At 2x1 and 1x2 the compressed step and the microbatched step; at 2x1
    the B = 1 sequence-sharded prefill and train step; the sequence-sharded
    batches refused (B = 2 at 2x1, B = 1 at 1x2); at 2x1 the compressed
    run's resume and the launcher."""
    torch.set_num_threads(1)
    meshes = {(2, 1): lmesh.make_host_mesh(1, device="cpu"),
              (1, 2): lmesh.make_host_mesh(2, device="cpu")}
    dense, binary = config(), config("binary")
    out = {}
    for shape, mesh in meshes.items():
        out[shape] = {
            "compressed": train(dense, mesh, n_steps=COMPRESSED_STEPS, grad_compress_M=M),
            "microbatch": train(dense, mesh, n_steps=1, microbatch=2)}
    out["seq_prefill"] = prefill(binary, meshes[(2, 1)], seq_sharded=True)
    out["seq_train"] = train(dense, meshes[(2, 1)], n_steps=1, batch=1, seq=PROMPT,
                             seq_sharded=True)
    out["refused"] = {shape: refuses_a_dividing_batch(binary, meshes[shape], batch)
                      for shape, batch in (((2, 1), 2), ((1, 2), 1))}
    out["resume"] = resume(dense, meshes[(2, 1)], os.path.join(ckpt_dir, "compressed"))
    out["launcher"] = launcher(os.path.join(ckpt_dir, "launcher"))
    return out
