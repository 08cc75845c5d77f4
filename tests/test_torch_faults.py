"""The port's fault injector and the service's disposition of each fault,
on the CPU.

One test per fault class, as in ``tests/test_faults.py``: the service
retries, screens, degrades or fails loudly, the queue drains, and its
counters reconcile with the injector's ledger.  Against the JAX package:
one seed gives the same ledger for the same calls (the draw order is
``rng.random(4)`` per call), and ``flip_bit_on_disk`` picks the same leaf
and bit.  The injector never changes a tensor the caller holds.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_programs as tp
from repro.testing import faults as jfaults
from repro_torch import deploy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.deploy import executor
from repro_torch.serve_cnn import CNNService, SLOConfig
from repro_torch.testing.faults import (FaultInjector, FaultPlan, InjectedFault,
                                        ManualClock, inject_faults)

jax.config.update("jax_platform_name", "cpu")

CLEAN = FaultPlan()
SHAPE = tp.NETS["conv_linear"][1]


@pytest.fixture(scope="module")
def program():
    return tp.torch_program("conv_linear", tp.packed_tree("conv_linear"))


def _imgs(n, seed=0):
    return tp.images(n, SHAPE, seed)


def _service(program, inj, clock, **kw):
    kw.setdefault("max_retries", 2)
    kw.setdefault("backoff_s", 0.001)
    return CNNService(program, clock=clock, sleep=clock.sleep,
                      execute_fn=inj.wrap_execute(executor.execute), **kw)


def _clear_on_sleep(inj, clock):
    """The retry backoff is the first sleep: attempt 0 faults, attempt 1
    runs clean."""
    def sleep(dt):
        clock.advance(dt)
        inj.plan = CLEAN
    return sleep


# ---------------------------------------------------------------------------
# the fault matrix, class by class
# ---------------------------------------------------------------------------

def test_executor_exception_is_retried(program):
    clock = ManualClock()
    inj = FaultInjector(FaultPlan(error_rate=1.0))
    svc = _service(program, inj, clock)
    svc.sleep = _clear_on_sleep(inj, clock)
    for im in _imgs(2):
        svc.submit(im)
    done = svc.drain()
    assert [r.status for r in done] == ["done"] * 2
    s = svc.stats
    assert s["retries"] == 1 and s["exec_exceptions"] == 1 == inj.counts["error"]
    assert s["fault_types"] == {"InjectedFault": 1}
    want = deploy.execute(program, svc.last_batch, svc.last_schedule)
    assert torch.equal(done[0].logits, want[0]) and not svc.queue


@pytest.mark.parametrize("field", ["nan_rate", "inf_rate"])
def test_nonfinite_output_is_screened_and_retried(program, field):
    clock = ManualClock()
    inj = FaultInjector(FaultPlan(**{field: 1.0}))
    svc = _service(program, inj, clock)
    svc.sleep = _clear_on_sleep(inj, clock)
    svc.submit(_imgs(1)[0])
    (req,) = svc.drain()
    assert req.status == "done" and torch.isfinite(req.logits).all()
    s = svc.stats
    assert s["nonfinite_detected"] == 1 == inj.counts["nan"] + inj.counts["inf"]
    assert s["retries"] == 1 and s["exec_exceptions"] == 0
    want = deploy.execute(program, svc.last_batch, svc.last_schedule)
    assert torch.equal(req.logits, want[0])


def test_latency_spike_degrades_the_ladder_then_recovers(program):
    clock = ManualClock()
    inj = FaultInjector(FaultPlan(latency_rate=1.0, latency_s=0.05), sleep=clock.sleep)
    svc = _service(program, inj, clock,
                   slo=SLOConfig(target_ms=10.0, window=16, min_samples=4,
                                 recover_at=0.5, recover_after=2))
    for i in range(4):
        for im in _imgs(4, seed=i):
            svc.submit(im)
        svc.step()
    assert svc.controller.rung > 0
    inj.plan = CLEAN
    for i in range(12):
        for im in _imgs(4, seed=10 + i):
            svc.submit(im)
        svc.step()
    s = svc.stats
    assert svc.controller.rung == 0 and len(s["rung_hist"]) > 1
    assert s["completed"] == s["admitted"] and inj.counts["latency"] == 4


def test_exhausted_retries_fail_loudly_and_the_queue_drains(program):
    clock = ManualClock()
    inj = FaultInjector(FaultPlan(error_rate=1.0))
    svc = _service(program, inj, clock, max_retries=2)
    svc.submit(_imgs(1)[0])
    (req,) = svc.step()
    assert req.status == "failed" and req.logits is None and "InjectedFault" in req.error
    s = svc.stats
    assert s["exec_failed_batches"] == 1 and s["retries"] == 2
    assert s["exec_exceptions"] == inj.counts["error"] == 3
    inj.plan = CLEAN
    after = svc.submit(_imgs(1, seed=9)[0])
    assert svc.drain() and after.status == "done" and not svc.queue


def test_truncated_checkpoint_fails_the_integrity_gate(program, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    deploy.save_program(mgr, 1, program)
    like = tp.zeroed(program)
    with inject_faults(FaultPlan(truncate_rate=1.0)) as inj:
        with pytest.raises(deploy.ProgramIntegrityError) as e:
            deploy.load_program(mgr, 1, like)
        assert inj.counts["truncate"] == 1
        assert "levels-mismatch" in {f.rule for f in e.value.findings}
        corrupt = deploy.load_program(mgr, 1, like, verify=False)
    assert corrupt.instrs[0].B_tap_packed.shape != program.instrs[0].B_tap_packed.shape
    back = deploy.load_program(mgr, 1, like)
    assert torch.equal(back.instrs[0].B_tap_packed, program.instrs[0].B_tap_packed)


# ---------------------------------------------------------------------------
# harness contracts
# ---------------------------------------------------------------------------

def test_inject_faults_patches_and_restores(program):
    real_exec, real_restore = executor.execute, CheckpointManager.restore
    x = torch.from_numpy(np.stack(_imgs(4)))
    with inject_faults(FaultPlan(error_rate=1.0)) as inj:
        assert executor.execute is not real_exec
        with pytest.raises(InjectedFault):
            executor.execute(program, x)
        assert torch.isfinite(deploy.execute(program, x)).all()   # stays clean
    assert executor.execute is real_exec and CheckpointManager.restore is real_restore
    assert inj.counts["error"] == 1
    with pytest.raises(RuntimeError, match="boom"):
        with inject_faults(FaultPlan()):
            raise RuntimeError("boom")
    assert executor.execute is real_exec


def test_service_default_path_sees_the_global_patch(program):
    clock = ManualClock()
    svc = CNNService(program, clock=clock, sleep=clock.sleep, max_retries=3,
                     backoff_s=0.001)
    with inject_faults(FaultPlan(error_rate=0.5, seed=3)) as inj:
        for im in _imgs(8):
            svc.submit(im)
        svc.drain()
    assert inj.counts["error"] > 0
    assert svc.stats["exec_exceptions"] == inj.counts["error"]


@pytest.mark.parametrize("seed", [0, 7])
def test_one_seed_gives_the_reference_ledger(program, seed):
    """The same plan and seed over twelve calls: the port's injector and the
    JAX package's count the same faults in the same calls."""
    plan = dict(latency_rate=0.3, error_rate=0.4, nan_rate=0.4, inf_rate=0.3, seed=seed)
    x = torch.from_numpy(np.stack(_imgs(4)))
    ledgers = []
    for inj, out in ((FaultInjector(FaultPlan(**plan), sleep=lambda s: None),
                      lambda p, x, m: deploy.execute(program, x, m)),
                     (jfaults.FaultInjector(jfaults.FaultPlan(**plan), sleep=lambda s: None),
                      lambda p, x, m: jnp.zeros((4, 10)))):
        fn = inj.wrap_execute(out)
        calls = []
        for _ in range(12):
            try:
                y = fn(program, x)
                calls.append("nan" if np.isnan(np.asarray(y)).any()
                             else "inf" if np.isinf(np.asarray(y)).any() else "ok")
            except (InjectedFault, jfaults.InjectedFault):
                calls.append("error")
        ledgers.append((dict(inj.counts), calls))
    assert ledgers[0] == ledgers[1]
    assert ledgers[0][0]["error"] > 0 and ledgers[0][0]["nan"] > 0


def test_poisoning_never_touches_the_callers_tensor(program):
    y = torch.ones(4, 10)
    for field in ("nan_rate", "inf_rate"):
        fn = FaultInjector(FaultPlan(**{field: 1.0})).wrap_execute(lambda p, x, m: y)
        out = fn(program, None)
        assert not torch.isfinite(out[0, 0]) and torch.isfinite(out.view(-1)[1:]).all()
        assert torch.equal(y, torch.ones(4, 10))


def test_zero_rate_plan_is_transparent(program):
    inj = FaultInjector(FaultPlan())
    x = torch.from_numpy(np.stack(_imgs(4)))
    assert torch.equal(inj.wrap_execute(executor.execute)(program, x),
                       deploy.execute(program, x))
    assert inj.counts["calls"] == 1
    assert sum(v for k, v in inj.counts.items() if k not in ("calls", "restores")) == 0
    clock = ManualClock(5.0)
    clock.sleep(0.25)
    clock.advance(0.75)
    assert clock() == 6.0
    assert {f.name for f in dataclasses.fields(FaultPlan)} == {
        f.name for f in dataclasses.fields(jfaults.FaultPlan)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("prefer", ["packed", "any"])
def test_disk_flip_picks_the_reference_leaf_and_bit(program, tmp_path, seed, prefer):
    mgr = CheckpointManager(str(tmp_path / "port"))
    step_dir = deploy.save_program(mgr, 1, program)
    shutil.copytree(step_dir, tmp_path / "jax")
    ours = FaultInjector(FaultPlan(seed=seed)).flip_bit_on_disk(step_dir, prefer=prefer)
    theirs = jfaults.FaultInjector(jfaults.FaultPlan(seed=seed)).flip_bit_on_disk(
        str(tmp_path / "jax"), prefer=prefer)
    assert ours == theirs
    a = np.load(f"{step_dir}/host_0.npz")
    b = np.load(tmp_path / "jax" / "host_0.npz")
    assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    with pytest.raises(Exception, match="digest"):
        mgr.restore(1, {"program": tp.zeroed(program)})


def test_memory_flip_hits_level_zero_bit_zero_on_a_copy():
    from repro_torch.core.binlinear import QuantConfig

    prog = deploy.abstract_program("mobilenet", QuantConfig(mode="binary", M=2),
                                   (1, 32, 32, 3), width_mult=0.25, n_classes=10,
                                   device="cpu")
    for idx in (0, 1, len(prog) - 1):            # conv, depth-wise, linear
        inj = FaultInjector(FaultPlan(seed=idx))
        bad = inj.flip_bit_in_program(prog, instr=idx)
        field = "B_packed" if prog.instrs[idx].kind == "linear" else "B_tap_packed"
        before, after = getattr(prog.instrs[idx], field), getattr(bad.instrs[idx], field)
        diff = (before ^ after).nonzero().tolist()
        assert len(diff) == 1 and diff[0][0] == 0
        pos = tuple(diff[0])
        assert int((before ^ after)[pos]) == 1
        if prog.instrs[idx].kind == "dwconv":
            assert pos[2] == 0                   # byte 0 of the channel axis
        else:
            assert pos[-2] == 0                  # byte 0 of the packed axis
        assert all(a is b for j, (a, b) in enumerate(zip(prog.instrs, bad.instrs))
                   if j != idx)
    assert inj.counts["bitflip_mem"] == 1
