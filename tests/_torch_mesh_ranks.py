"""Per-rank bodies of ``tests/test_torch_distributed.py``.

``distributed.run_local`` pickles these by import path and the spawned
ranks import this module, so it imports only torch and the port: a rank
never loads jax.  Each body loads the program the parent saved, runs the
sharded forwards and returns numpy arrays for the parent to compare.
"""
import torch

from repro_torch import deploy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.binlinear import QuantConfig
from repro_torch.distributed import cache_stats, execute_sharded, plan_mesh
from repro_torch.kernels import ops
from repro_torch.serve_cnn import CNNService, SLOConfig
from repro_torch.testing.faults import ManualClock

M = 2
SERVE_BATCH, SERVE_STEPS = 8, 3
CLOCK_STEP_S = (0.0, 1.0)       # how far each rank's fake clock moves per step
SLO = SLOConfig(target_ms=100.0, min_samples=SERVE_BATCH)


def load(ckpt_dir: str, spec: tuple, device: str = "cpu"):
    """The program the parent saved: ``spec`` is (arch, input shape,
    abstract_program kwargs)."""
    arch, shape, kw = spec
    like = deploy.abstract_program(arch, QuantConfig(mode="binary", M=M), shape, **kw,
                                   device=device)
    return deploy.load_program(CheckpointManager(ckpt_dir, scrub=False), 0, like)


def schedules(program) -> dict:
    return {"none": None, "one": 1,
            "per_layer": tuple(1 + (i % 2) for i in range(len(program.instrs)))}


def sharded(rank, world, ckpt_dir, spec, meshes, inputs):
    """Every (mesh, input, schedule) forward; per case the logits, whether
    the forward picked a plan, and the bound-slice count after one repeat."""
    program = load(ckpt_dir, spec)
    out = {}
    for n_data, n_model in meshes:
        plan = plan_mesh(program, n_data=n_data, n_model=n_model, min_shard_bytes=0)
        for name, x in inputs.items():
            for label, m in schedules(program).items():
                xt = torch.from_numpy(x)
                picks = ops.plan_pick_count()
                y = execute_sharded(program, plan, xt, m)
                picked = ops.plan_pick_count() - picks
                bound = cache_stats()["local_instrs"]
                execute_sharded(program, plan, xt, m)
                out[(n_data, n_model, name, label)] = {
                    "logits": y.numpy(), "picks": picked,
                    "bound_grew": cache_stats()["local_instrs"] - bound}
    return out


def serve(rank, world, ckpt_dir, spec, n_data, n_model, images, clock_step_s):
    """``CNNService(mesh_plan=...)`` over ``images`` (all submitted at once),
    the fake clock moving ``clock_step_s[rank]`` before each step.  Returns
    the logits, each request's schedule, and this rank's own rung."""
    program = load(ckpt_dir, spec)
    plan = plan_mesh(program, n_data=n_data, n_model=n_model, min_shard_bytes=0)
    return serve_requests(program, images, clock_step_s[rank], mesh_plan=plan)


def serve_requests(program, images, clock_step_s: float, mesh_plan=None) -> dict:
    clock = ManualClock()
    svc = CNNService(program, slo=SLO, batch_size=SERVE_BATCH, max_queue=len(images),
                     clock=clock, sleep=clock.sleep, mesh_plan=mesh_plan)
    reqs = [svc.submit(img) for img in images]
    for _ in range(SERVE_STEPS):
        clock.advance(clock_step_s)
        svc.step()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return {"logits": torch.stack([r.logits for r in reqs]).numpy(),
            "schedules": [r.m_schedule for r in reqs],
            "own_rung": svc.controller.rung}


def both(rank, world, ckpt_dir, spec, meshes, inputs, images):
    """One world-2 spawn: the sharded forwards and the service."""
    return {"sharded": sharded(rank, world, ckpt_dir, spec, meshes, inputs),
            "serve": serve(rank, world, ckpt_dir, spec, 2, 1, images, CLOCK_STEP_S)}
