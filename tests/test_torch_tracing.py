"""The port's spans (``repro_torch.tracing``), on the CPU.

Under ``torch.profiler`` (CPU activity) each ``CNNService.step`` is one
``serve.step`` span over ``serve.assemble``, ``serve.h2d``,
``executor.execute``, ``serve.screen`` and ``serve.d2h``, in that order and
nested in time, and each ``execute`` one ``executor.<instr>`` span per
instruction in program order.  With no profiler nothing enters
``record_function``, and answers and ``stats`` are the same either way.
Faults (raised, NaN, a failing instruction) leave one ``serve.screen`` per
attempt that reached it and every span closed inside its step.
"""
import dataclasses
import json
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_programs as tp
from repro_torch import deploy, tracing
from repro_torch.deploy import executor
from repro_torch.serve_cnn import CNNService
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultPlan, ManualClock

STEP_CHILDREN = ["serve.assemble", "serve.h2d", "executor.execute", "serve.screen",
                 "serve.d2h"]
EPS_US = 0.01   # the chrome trace rounds times to the nanosecond


@pytest.fixture(scope="module")
def program():
    return tp.torch_program("conv_linear", tp.packed_tree("conv_linear"), golden=False)


def _spans(prof, tmp_path) -> list[dict]:
    """The ``user_annotation`` spans of a finished profile, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X"), key=lambda e: float(e["ts"]))


def _within(child, parent) -> bool:
    return (float(parent["ts"]) - EPS_US <= float(child["ts"])
            and float(child["ts"]) + float(child["dur"])
            <= float(parent["ts"]) + float(parent["dur"]) + EPS_US
            and child["tid"] == parent["tid"] and child is not parent)


def _named(spans, name):
    return [e for e in spans if e["name"] == name]


def _service(program, clock=None, **kw):
    clock = clock or ManualClock()
    return CNNService(program, batch_size=2, max_queue=16, clock=clock,
                      sleep=clock.sleep, **kw)


def _submit(svc, n, seed=0):
    return [svc.submit(im) for im in tp.images(n, tp.NETS["conv_linear"][1], seed)]


def test_span_is_one_shared_no_op_with_no_profiler():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        assert isinstance(tracing.span("a"), torch.profiler.record_function)


def test_a_step_is_one_serve_step_over_its_five_children_in_order(program, tmp_path):
    svc = _service(program)
    _submit(svc, 6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            svc.step()
    spans = _spans(prof, tmp_path)
    steps = _named(spans, "serve.step")
    assert len(steps) == 3
    for step in steps:
        kids = [e for e in spans if _within(e, step) and (
            e["name"].startswith("serve.") or e["name"] == "executor.execute")]
        assert [e["name"] for e in kids] == STEP_CHILDREN
        for a, b in zip(kids, kids[1:]):   # one after the other, not nested
            assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"]) + EPS_US


@pytest.mark.parametrize("net", ["conv_linear", "linear"])
def test_execute_has_one_span_per_instruction_in_program_order(net, tmp_path):
    prog = tp.torch_program(net, tp.packed_tree(net), golden=False)
    x = torch.from_numpy(tp.images(1, tp.NETS[net][1])[0]).expand(
        tp.NETS[net][1]).contiguous()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = deploy.execute(prog, x)
    spans = _spans(prof, tmp_path)
    (outer,) = _named(spans, "executor.execute")
    inner = [e for e in spans if _within(e, outer)]
    assert [e["name"] for e in inner] == [f"executor.{i.name}" for i in prog.instrs]
    assert torch.equal(y, deploy.execute(prog, x))


def test_an_unnamed_instruction_is_spanned_by_its_index(program, tmp_path):
    prog = dataclasses.replace(program, instrs=tuple(
        dataclasses.replace(instr, name="") if i == 1 else instr
        for i, instr in enumerate(program.instrs)))
    x = torch.zeros(tp.NETS["conv_linear"][1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        deploy.execute(prog, x)
    names = [e["name"] for e in _spans(prof, tmp_path)]
    assert names == ["executor.execute", f"executor.{program.instrs[0].name}", "executor.1"]


def test_no_profiler_means_no_record_function(program, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    svc = _service(program)
    reqs = _submit(svc, 4)
    svc.drain()
    assert all(r.status == "done" for r in reqs)
    deploy.execute(program, svc.last_batch)
    # the same patch is reached once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            deploy.execute(program, svc.last_batch)


def test_logits_and_stats_are_the_same_with_and_without_the_profiler(program):
    def serve(profiled: bool):
        clock = ManualClock()
        svc = _service(program, clock)
        reqs = []
        with profile(activities=[ProfilerActivity.CPU]) if profiled else nullcontext():
            for t in range(4):
                reqs += _submit(svc, 3, seed=t)
                clock.advance(0.003)
                svc.step()
            while svc.queue:
                clock.advance(0.001)
                svc.step()
        return reqs, svc.stats

    plain, stats = serve(False)
    traced, traced_stats = serve(True)
    assert stats == traced_stats and stats["completed"] == 12
    assert "p99_latency_s" in stats
    for a, b in zip(plain, traced, strict=True):
        assert (a.status, a.latency_s, a.m_schedule) == (b.status, b.latency_s, b.m_schedule)
        assert torch.equal(a.logits, b.logits)


def test_faults_leave_one_screen_per_attempt_that_reached_it(program, tmp_path):
    clock = ManualClock()
    plan = FaultPlan(error_rate=0.4, nan_rate=0.4, seed=3)
    with faults.inject_faults(plan, sleep=clock.sleep) as inj:
        svc = _service(program, clock, max_retries=1)
        _submit(svc, 16)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            steps = 0
            while svc.queue:
                svc.step()
                steps += 1
    stats, counts = svc.stats, inj.counts
    # the trace reaches a retry, a non-finite output and exhausted retries
    assert stats["retries"] and stats["nonfinite_detected"] and stats["exec_failed_batches"]
    spans = _spans(prof, tmp_path)
    step_spans = _named(spans, "serve.step")
    assert len(step_spans) == steps
    reached = counts["calls"] - counts["error"]
    assert len(_named(spans, "serve.screen")) == reached
    assert len(_named(spans, "executor.execute")) == reached
    assert len(_named(spans, "serve.d2h")) == stats["batches"] - stats["exec_failed_batches"]
    for e in spans:
        if e["name"] != "serve.step":
            assert sum(_within(e, s) for s in step_spans) == 1, e["name"]


def test_spans_close_when_an_instruction_raises(program, monkeypatch, tmp_path):
    real = executor._apply

    def failing(instr, y, m):
        if instr is program.instrs[-1]:
            raise RuntimeError("launch refused")
        return real(instr, y, m)

    monkeypatch.setattr(executor, "_apply", failing)
    svc = _service(program, max_retries=1)
    reqs = _submit(svc, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc.step()
    assert {r.status for r in reqs} == {"failed"}
    spans = _spans(prof, tmp_path)
    (step,) = _named(spans, "serve.step")
    executes = _named(spans, "executor.execute")
    assert len(executes) == 2 and not _named(spans, "serve.screen")
    last = f"executor.{program.instrs[-1].name}"
    for ex in executes:
        assert _within(ex, step)
        assert [e["name"] for e in spans if _within(e, ex)] == [
            f"executor.{i.name}" for i in program.instrs]
        (fail,) = [e for e in _named(spans, last) if _within(e, ex)]
        assert float(fail["dur"]) >= 0
