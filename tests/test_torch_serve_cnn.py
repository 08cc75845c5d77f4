"""The port's CNNService and SLO controller, on the CPU.

* Against the JAX package: the same linear-only program (the JAX package
  runs its real Pallas matmul in interpret mode), the same ``ManualClock``
  trace with deadlines and the same seeded ``FaultPlan`` drive both
  services; per request ``status``, ``shed_reason``, ``rung``,
  ``m_schedule`` and ``batch_index`` are equal, and so are the ``stats``
  and the injectors' ``counts``.  Logits agree with the JAX package's
  within rtol 1e-5 / atol 1e-4 and are ``torch.equal`` to the port's
  ``execute`` on the same padded batch at that schedule.  Both
  ``SLOController``\\ s walk the same rung / shedding trajectory under one
  latency trace.
* The port alone: every rung bit-exact against ``execute``, admission and
  deadlines, SLO feedback, and the watchdog's hot reload, as in
  ``tests/test_serve_cnn.py`` and ``tests/test_checkpoint_integrity.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_programs as tp
from repro.serve_cnn import CNNService as JService
from repro.serve_cnn import SLOConfig as JSLOConfig
from repro.serve_cnn import SLOController as JController
from repro.testing import faults as jfaults
from repro_torch import deploy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.serve_cnn import (CNNService, SLOConfig, SLOController,
                                   default_ladder)
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultInjector, FaultPlan, ManualClock

jax.config.update("jax_platform_name", "cpu")

SHAPE = tp.NETS["conv_linear"][1]


@pytest.fixture(scope="module")
def program():
    return tp.torch_program("conv_linear", tp.packed_tree("conv_linear"))


def _images(n, seed=0):
    return tp.images(n, SHAPE, seed)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

SLO_KW = dict(target_ms=15.0, window=8, min_samples=4, recover_at=0.5, recover_after=2)


def _drive(service_cls, slo_cls, fault_mod, program, images):
    """Twelve 5 ms frames of three arrivals each (every third with a 15 ms
    deadline) into batches of two, one step per frame, then a drain; faults
    drawn from seed 7.
    Returns the requests, the service's stats, the injector's counts and
    ``{request id: (padded batch, schedule)}`` for each served request."""
    clock = fault_mod.ManualClock()
    plan = fault_mod.FaultPlan(latency_rate=0.3, latency_s=0.02, error_rate=0.25,
                               nan_rate=0.1, inf_rate=0.1, seed=7)
    reqs, served = [], {}
    with fault_mod.inject_faults(plan, sleep=clock.sleep) as inj:
        svc = service_cls(program, batch_size=2, max_queue=6, max_retries=1,
                          backoff_s=0.004, clock=clock, sleep=clock.sleep,
                          slo=slo_cls(**SLO_KW))

        def step():
            for r in svc.step():
                if r.status == "done":
                    served[r.id] = (svc.last_batch, svc.last_schedule)

        for t in range(12):
            for j in range(3):
                deadline = clock() + (0.015 if j == 2 else 1.0)
                reqs.append(svc.submit(images[3 * t + j], deadline_s=deadline))
            step()
            clock.advance(0.005)
        while svc.queue:
            step()
    return reqs, svc.stats, inj.counts, served


def test_service_outcomes_equal_the_reference():
    tree = tp.packed_tree("linear")
    jprog = tp.jax_program("linear", tree)
    prog = tp.torch_program("linear", tree, golden=False)
    images = tp.images(36, tp.NETS["linear"][1], seed=5)
    jreqs, jstats, jcounts, _ = _drive(JService, JSLOConfig, jfaults, jprog, images)
    reqs, stats, counts, served = _drive(CNNService, SLOConfig, faults, prog, images)
    assert stats == jstats
    assert counts == jcounts
    # the trace reaches every outcome, shed reason and rung
    assert {r.status for r in reqs} == {"done", "shed", "failed"}
    assert all(stats["shed"].values()) and set(stats["rung_hist"]) == {0, 1, 2}
    assert stats["retries"] and stats["exec_failed_batches"] and stats["nonfinite_detected"]
    for ours, theirs in zip(reqs, jreqs, strict=True):
        for field in ("id", "status", "shed_reason", "rung", "m_schedule", "batch_index",
                      "latency_s"):
            assert getattr(ours, field) == getattr(theirs, field), (ours.id, field)
        if ours.status == "done":
            np.testing.assert_allclose(ours.logits.numpy(), theirs.logits,
                                       rtol=1e-5, atol=1e-4)
            batch, sched = served[ours.id]
            want = deploy.execute(prog, batch, sched)[ours.batch_index]
            assert torch.equal(ours.logits, want)


def test_controller_trajectory_equals_the_reference():
    ladder = ((2, 2, 2), (1, 2, 2), (1, 1, 1))
    ours = SLOController(ladder, SLOConfig(**SLO_KW))
    theirs = JController(ladder, JSLOConfig(**SLO_KW))
    rng = np.random.default_rng(0)
    trace = []
    for phase, scale in ((0, 0.005), (1, 0.04), (2, 0.002), (3, 0.05), (4, 0.001)):
        for _ in range(30):
            for lat in rng.exponential(scale, size=4):
                ours.observe(lat)
                theirs.observe(lat)
            ours.update()
            theirs.update()
            trace.append((ours.rung, ours.shedding))
            assert (ours.rung, ours.shedding, ours.pressure()) == (
                theirs.rung, theirs.shedding, theirs.pressure())
    assert {r for r, _ in trace} == {0, 1, 2} and any(s for _, s in trace)
    assert (ours.rung_changes, ours.shed_transitions) == (
        theirs.rung_changes, theirs.shed_transitions)


# ---------------------------------------------------------------------------
# the ladder, admission and SLO feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rung", [0, 1, 2])
def test_every_rung_is_bit_exact_against_execute(program, rung):
    sched = default_ladder(program)[rung]
    svc = CNNService(program, initial_rung=rung, batch_size=4)
    reqs = [svc.submit(im) for im in _images(3, seed=rung)]
    done = svc.drain()
    assert [r.status for r in done] == ["done"] * 3 and reqs[0] is done[0]
    assert svc.last_batch.shape == (4, 8, 8, 3) and not svc.last_batch[3].any()
    want = deploy.execute(program, svc.last_batch, sched)
    for r in done:
        assert r.m_schedule == sched and r.rung == rung
        assert torch.equal(r.logits, want[r.batch_index])


def test_admission_sheds_with_named_reasons(program):
    clock = ManualClock(100.0)
    svc = CNNService(program, clock=clock, batch_size=2, max_queue=3)
    with pytest.raises(ValueError, match=r"\(9, 8, 3\).*\(8, 8, 3\)"):
        svc.submit(np.zeros((9, 8, 3), np.float32))
    late = svc.submit(_images(1)[0], deadline_s=99.0)
    assert late.status == "shed" and late.shed_reason == "deadline_expired"
    ok = svc.submit(_images(1)[0])
    tight = svc.submit(_images(1)[0], deadline_s=clock() + 0.5)
    extra = [svc.submit(im) for im in _images(2)]
    assert [r.status for r in extra] == ["queued", "shed"]
    assert extra[1].shed_reason == "queue_full"
    clock.advance(1.0)                       # tight's deadline passes while queued
    finished = svc.step()
    assert tight in finished and tight.shed_reason == "deadline_expired"
    assert ok.status == "done" and extra[0].status == "done"
    assert svc.stats["shed"] == {"queue_full": 1, "deadline_expired": 2, "slo_shed": 0}
    for im in _images(3):
        svc.submit(im)
    with pytest.raises(RuntimeError, match="failed to drain"):
        svc.drain(max_steps=1)


def _pressured_service(program, slow_s, clock):
    """Service whose executor advances the virtual clock by ``slow_s[i]``
    on call i."""
    calls = [0]

    def execute_fn(prog, x, sched):
        clock.advance(slow_s[min(calls[0], len(slow_s) - 1)])
        calls[0] += 1
        return deploy.execute(prog, x, sched)

    return CNNService(program, batch_size=4, clock=clock, sleep=clock.sleep,
                      execute_fn=execute_fn,
                      slo=SLOConfig(target_ms=10.0, window=16, min_samples=4,
                                    recover_at=0.5, recover_after=2))


def test_degrades_under_pressure_sheds_as_backpressure_then_recovers(program):
    svc = _pressured_service(program, [0.05] * 10 + [0.0], ManualClock())
    rungs, shed_seen = [], False
    for i in range(40):
        for im in _images(8, seed=i):        # twice the service rate
            svc.submit(im)
        svc.step()
        rungs.append(svc.controller.rung)
        shed_seen = shed_seen or svc.controller.shedding
        if shed_seen and not svc.controller.shedding and svc.controller.rung == 0:
            break
    assert shed_seen and rungs[-1] == 0 and max(rungs) == 2
    assert set(svc.stats["rung_hist"]) == {0, 1, 2}
    assert svc.stats["shed"]["slo_shed"] > 0 and svc.stats["completed"] > 0
    svc.drain()
    assert not svc.queue


# ---------------------------------------------------------------------------
# the watchdog: golden self-test and hot reload
# ---------------------------------------------------------------------------

def test_watchdog_detects_and_hot_reloads(program, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    deploy.save_program(mgr, 1, program)
    clock = ManualClock()
    svc = CNNService(program, batch_size=4, clock=clock, sleep=clock.sleep,
                     selftest_every=2, checkpoint_manager=mgr,
                     restore_like=tp.zeroed(program))
    for im in _images(4):
        svc.submit(im)
    svc.step()
    assert svc.stats["selftest_runs"] == 1 and svc.stats["selftest_failures"] == 0
    inj = FaultInjector(FaultPlan(seed=2))
    svc.program = inj.flip_bit_in_program(svc.program)
    for i in range(2):
        for im in _images(4, seed=i + 1):
            svc.submit(im)
        done = svc.step()
    s = svc.stats
    assert s["selftest_failures"] == 1 == inj.counts["bitflip_mem"]
    assert s["reloads"] == 1 and svc.last_reload_step == 1
    assert s["quarantined_steps"] == 0 and svc.quarantined_program is not None
    want = deploy.execute(program, svc.last_batch, svc.last_schedule)
    assert all(torch.equal(r.logits, want[r.batch_index]) for r in done)


def test_watchdog_without_a_manager_reraises_and_needs_golden(program):
    svc = CNNService(program, batch_size=4, selftest_every=1)
    svc.program = FaultInjector(FaultPlan()).flip_bit_in_program(program)
    svc.submit(_images(1)[0])
    with pytest.raises(deploy.SelfTestFailure):
        svc.step()
    with pytest.raises(ValueError, match="GoldenRecord"):
        CNNService(dataclasses.replace(program, golden=None), selftest_every=2)
    with pytest.raises(ValueError, match="selftest_every"):
        CNNService(program, selftest_every=0)


def test_new_entry_points_default_to_the_card(program, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    from repro_torch.core.binlinear import QuantConfig

    with pytest.raises(RuntimeError, match="cuda"):
        deploy.abstract_program("cnn_a", QuantConfig(mode="binary"), (1, 48, 48, 3))
    like = deploy.abstract_program("cnn_a", QuantConfig(mode="binary"), (1, 48, 48, 3),
                                   device="cpu")
    assert like.device.type == "cpu" and like.golden is None
