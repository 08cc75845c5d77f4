"""Per-rank bodies of ``tests/test_torch_mesh_lm.py``.

``distributed.run_local`` pickles these by import path and the spawned
ranks import this module, so it imports only torch and the port: a rank
never loads jax.  Each body runs the port's sharded LM on a mesh of the
spawned ranks (gloo, on the CPU) and returns numpy arrays for the parent
to compare.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import pipeline as lpipe
from repro_torch.launch import steps
from repro_torch.launch import train as ltrain
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.optim import sgd
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding import placement as pl

TRAIN_STEPS, BATCH, SEQ, LR = 2, 4, 8, 0.5


def optimizer():
    """SGD with momentum (the global-norm clip at 1.0): its update follows
    the gradient's size, so a mesh step is compared with the single-process
    one through the update itself (an AdamW step moves every weight by
    about lr whatever its gradient, so a gradient of ~0 whose sign the sum
    order flips lands 2 lr away)."""
    return sgd(LR)


def _numpy(tree):
    return cm.tree_map(lambda t: pl.full(t).numpy(), tree)


def _recording(calls: list):
    """``ops.binary_matmul`` that records the shapes each call gets."""
    real = ops.binary_matmul

    def wrapped(x, B_packed, alpha, **kw):
        if not isinstance(x, torch.Tensor) or pl.is_dtensor(B_packed) or pl.is_dtensor(x):
            raise AssertionError("the kernel wrapper got a DTensor")
        calls.append((tuple(x.shape), tuple(B_packed.shape)))
        return real(x, B_packed, alpha, **kw)
    return wrapped


def packed_params(cfg, seed: int = 0):
    """The packed tree of ``cfg`` from a seed: drawn and binarized on the
    CPU, the same bytes in every process (the ranks make their own rather
    than take it pickled: ``spawn`` hands each rank its arguments in turn,
    after the rank has imported torch)."""
    return api.binarize_model_params(
        cfg, api.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"))


def bf16(cfg, packed):
    """``cfg`` and its packed tree in bf16: the embedding and norms cast,
    the packed bits and alphas (fp32, as binarize makes them) kept."""
    return cfg.replace(dtype="bfloat16"), cm.tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 and t.ndim < 4 else t, packed)


def serve(rank, world, cfg, batch_np, prompt_np, n_model):
    """The packed decode step and the prefill forward on a
    ``(world / n_model) x n_model`` mesh, FSDP and TP-only, and the decode
    step in bf16; per case the logits, the cache after the step, and the
    kernel calls of the step.  Then one decode step whose kernel call fails
    must raise."""
    torch.set_num_threads(1)    # a tiny model: the spawns share the host with each other
    mesh = lmesh.make_host_mesh(n_model, device="cpu")
    packed = packed_params(cfg)
    out, calls, real = {}, [], ops.binary_matmul
    ops.binary_matmul = _recording(calls)
    try:
        for fsdp in (True, False):
            step = steps.build_serve_step(cfg, mesh, fsdp_params=fsdp)
            params = step.shard_params(packed)
            batch = step.shard_batch(params_from_numpy(batch_np, device="cpu"))
            calls.clear()
            logits, cache = step(params, batch)
            out[("decode", fsdp)] = {"logits": pl.full(logits).numpy(),
                                     "cache": _numpy(cache), "calls": list(calls)}
            pre = steps.build_serve_step(cfg, mesh, kind="prefill", fsdp_params=fsdp)
            calls.clear()
            logits = pre(pre.shard_params(packed),
                         pre.shard_batch({"tokens": torch.from_numpy(prompt_np)}))
            out[("prefill", fsdp)] = {"logits": pl.full(logits).numpy(), "calls": list(calls)}
        cfg16, packed16 = bf16(cfg, packed)
        step16 = steps.build_serve_step(cfg16, mesh)
        batch16 = cm.tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
                              params_from_numpy(batch_np, device="cpu"))
        logits, _ = step16(step16.shard_params(packed16), step16.shard_batch(batch16))
        out["bf16"] = pl.full(logits).float().numpy()

        def broken(*a, **kw):
            raise RuntimeError("kernel launch failed")
        ops.binary_matmul = broken
        try:
            step(params, batch)
            out["raised"] = False
        except RuntimeError as e:
            out["raised"] = "kernel launch failed" in str(e)
    finally:
        ops.binary_matmul = real
    return out


def _data(cfg):
    return SyntheticTokens(cfg.vocab, SEQ, BATCH, device="cpu")


def _train(cfg, mesh):
    """TRAIN_STEPS mesh steps from seed 0 on the synthetic batches."""
    opt = optimizer()
    state = steps.init_train_state(cfg, opt, device="cpu", mesh=mesh)
    step_fn = steps.build_train_step(cfg, opt, mesh=mesh)
    data, losses = _data(cfg), []
    for _ in range(TRAIN_STEPS):
        state, met = step_fn(state, data.next_batch())
        losses.append(float(met["loss"]))
    return state, losses


def _trainer(cfg, mesh, ckpt_dir, total):
    opt = optimizer()
    return Trainer(steps.build_train_step(cfg, opt, mesh=mesh),
                   steps.init_train_state(cfg, opt, seed=1, device="cpu", mesh=mesh),
                   _data(cfg), TrainerConfig(total_steps=total, checkpoint_every=TRAIN_STEPS,
                                             checkpoint_dir=ckpt_dir, log_every=1000),
                   state_shardings=steps.train_state_shardings(cfg, mesh, opt))


LAUNCH_ARGS = ("--arch", "gemma_2b", "--reduced", "--steps", str(TRAIN_STEPS), "--batch",
               str(BATCH), "--seq", str(SEQ), "--device", "cpu")


def launcher(ckpt_dir: str) -> dict:
    """``launch/train.py``'s ``main`` as a multi-rank launcher starts it
    (``WORLD_SIZE`` set), in this rank's process group: its losses, the
    checkpoint steps its Trainer wrote, and whether the group it did not
    start is left to its owner."""
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    try:
        report = ltrain.main([*LAUNCH_ARGS, "--checkpoint-dir", ckpt_dir])
    finally:
        del os.environ["WORLD_SIZE"]
    dist.barrier()
    return {"losses": report.losses, "group_left": dist.is_initialized(),
            "saved": CheckpointManager(ckpt_dir).all_steps()}


def _production_meshes(rank: int) -> dict:
    """make_production_mesh on torch's fake process group of 256 and of 512
    ranks (this rank's gloo group is left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    out = {}
    dist.barrier()
    dist.destroy_process_group()
    for multi, world in ((False, 256), (True, 512)):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        m = lmesh.make_production_mesh(multi_pod=multi, device="cpu")
        out[multi] = (tuple(m.mesh_dim_names), tuple(m.shape))
    return out    # run_local destroys the last (fake) group


def train(rank, world, cfg, ckpt_dir, stage_np, x_np):
    """The mesh train step at 2x1 and 1x2; a Trainer on 2x1 that saves,
    restore(shardings=) onto 1x2, a Trainer that resumes there; the GPipe
    pipeline over 2 stages; the training launcher on the world's mesh; the
    production meshes on a fake group."""
    torch.set_num_threads(1)
    meshes = {(2, 1): lmesh.make_host_mesh(1, device="cpu"),
              (1, 2): lmesh.make_host_mesh(2, device="cpu")}
    out = {"steps": {}}
    for shape, mesh in meshes.items():
        state, losses = _train(cfg, mesh)
        out["steps"][shape] = {
            "losses": losses, "params": _numpy(state["params"]),
            "placements": str(state["params"]["layers"]["ffn"]["w_up"]["w"].placements)}
    # save at 2x1 (a Trainer's checkpoint), restore onto 1x2
    first = _trainer(cfg, meshes[(2, 1)], ckpt_dir, TRAIN_STEPS)
    first.run()
    opt = optimizer()
    target = steps.init_train_state(cfg, opt, seed=2, device="cpu", mesh=meshes[(1, 2)])
    restored, extra = CheckpointManager(ckpt_dir).restore(
        TRAIN_STEPS, target, shardings=steps.train_state_shardings(cfg, meshes[(1, 2)], opt))
    saved = cm.tree_leaves({k: first.state[k] for k in ("params", "opt_state")})
    back = cm.tree_leaves({k: restored[k] for k in ("params", "opt_state")})
    out["restore"] = {
        "equal": all(torch.equal(pl.full(a), pl.full(b)) for a, b in zip(saved, back)),
        "placements": [str(t.placements) for t in back if pl.is_dtensor(t)][:3],
        "mesh": [tuple(t.device_mesh.shape) for t in back if pl.is_dtensor(t)][0],
        "step": int(restored["step"]), "data_state": extra.get("data_state")}
    second = _trainer(cfg, meshes[(1, 2)], ckpt_dir, TRAIN_STEPS + 1)
    out["resumed_from"] = second.maybe_resume() and second.report.resumed_from
    report = second.run()
    out["resume"] = {"losses": report.losses, "params": _numpy(second.state["params"])}
    # GPipe over 2 stages
    pmesh = lpipe.make_pipeline_mesh(2, device="cpu")
    stage = {k: torch.from_numpy(v) for k, v in stage_np.items()}
    out["pipeline"] = lpipe.pipeline_apply(
        lambda p, h: torch.tanh(h @ p["w"] + p["b"]), stage, torch.from_numpy(x_np),
        mesh=pmesh, n_micro=6).numpy()
    out["launcher"] = launcher(os.path.join(ckpt_dir, "launcher"))
    out["production"] = _production_meshes(rank)
    return out
