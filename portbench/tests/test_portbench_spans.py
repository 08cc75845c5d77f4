"""The span arithmetic (``portbench/spans.py``) and the six serve readers
that use it, on fixed events."""
import math
import time

import numpy as np
import pytest
import torch

from portbench import check, devtrace, harness, manifest, network, spans
from portbench import weights as wts
from portbench.tests import toy

SERVE = "mobilenet_v1_224.serve_b16_poisson"
READERS = ("serve.step_p95_ms", "serve.assemble_ms", "serve.h2d_ms",
           "executor.issue_ms.serve", "serve.screen_ms", "serve.step_self_ms")


def _span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": float(ts), "dur": float(end - ts)}


def _events():
    """Two steps of 100 µs under the benchmark's ``portbench.step``.  The
    first is plain: 23 µs of it lie outside its five children.  The second
    retries after a NaN: two executes and two screens, 17 µs outside.  A
    span of another thread falls inside the first step's time; a kernel is
    launched in ``executor.pw0``, one in ``executor.fc``, a copy in
    ``serve.h2d``, and one kernel's launch is missing."""
    ev = [_span("portbench.step", -1, 101), _span("serve.step", 0, 100),
          _span("serve.assemble", 5, 30), _span("serve.h2d", 30, 40),
          _span("executor.execute", 42, 60), _span("executor.pw0", 43, 50),
          _span("executor.fc", 50, 59), _span("serve.screen", 61, 80),
          _span("serve.d2h", 80, 85),
          _span("serve.assemble", 50, 60, tid=2),
          _span("portbench.step", 199, 301), _span("serve.step", 200, 300),
          _span("serve.assemble", 200, 210), _span("serve.h2d", 210, 220),
          _span("executor.execute", 222, 240), _span("serve.screen", 240, 250),
          _span("executor.execute", 255, 270), _span("serve.screen", 270, 280),
          _span("serve.d2h", 280, 290)]
    launch = {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1, "dur": 1.0}
    ev += [dict(launch, name="cudaLaunchKernel", ts=44.0, args={"correlation": 7}),
           dict(launch, name="cudaLaunchKernel", ts=52.0, args={"correlation": 8}),
           dict(launch, name="cudaMemcpyAsync", ts=35.0, args={"correlation": 9})]
    device = {"ph": "X", "pid": 0, "tid": 7}
    ev += [dict(device, cat="kernel", name="binary_conv_kernel", ts=61.0, dur=3.0,
                args={"correlation": 7}),
           dict(device, cat="kernel", name="binary_matmul_kernel", ts=64.0, dur=2.0,
                args={"correlation": 8}),
           dict(device, cat="gpu_memcpy", name="Memcpy HtoD", ts=36.0, dur=4.0,
                args={"correlation": 9}),
           dict(device, cat="kernel", name="reduce_kernel", ts=66.0, dur=0.5,
                args={"correlation": 11})]
    return ev


def _ctx(events):
    return harness.TraceContext(events=events, split=devtrace.device_split(events), net=[],
                                sched=[], batch=16, calls=2)


def test_children_are_the_spans_inside_on_the_same_thread():
    sp = spans.annotations(_events())
    first = spans.named(sp, "serve.step")[0]
    assert [e["name"] for e in spans.inside(first, sp)] == [
        "serve.assemble", "serve.h2d", "executor.execute", "executor.pw0", "executor.fc",
        "serve.screen", "serve.d2h"]


def test_self_time_counts_overlapping_children_once():
    parent = _span("p", 0, 100)
    kids = [_span("a", 10, 50), _span("b", 30, 60), _span("c", 90, 120)]
    assert spans.self_us(parent, kids) == 100 - 50 - 10
    assert spans.union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_readers_sum_per_step_and_average_over_steps_with_a_retry():
    ctx = _ctx(_events())
    want = {"serve.step_p95_ms": 0.1,
            "serve.assemble_ms": (25 + 10) / 2e3,
            "serve.h2d_ms": (10 + 10) / 2e3,
            "executor.issue_ms.serve": (18 + 18 + 15) / 2e3,
            "serve.screen_ms": (19 + 10 + 10) / 2e3,
            "serve.step_self_ms": (23 + 17) / 2e3}
    for name in READERS:
        assert math.isclose(manifest.reader(name)(ctx), want[name]), name


def test_step_p95_is_the_nearest_rank():
    kernel = {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": 0.0,
              "dur": 1.0}
    ev = [_span("serve.step", 1000 * i, 1000 * i + 10 * (i + 1)) for i in range(20)]
    assert math.isclose(manifest.reader("serve.step_p95_ms")(_ctx(ev + [kernel])), 0.19)


def test_readers_find_nothing_in_a_trace_without_the_cards_spans():
    ev = [e for e in _events() if e["cat"] == "user_annotation"]
    assert spans.per_step_ms(ev, "serve.h2d") == 0.01
    for name in READERS:
        assert manifest.reader(name)(_ctx(ev)) is None, name


def test_a_kernel_is_credited_to_its_instruction_by_correlation():
    got = spans.device_us_by_instruction(_events())
    assert got == {"executor.pw0": 3.0, "executor.fc": 2.0, None: 4.5}


def test_readers_find_nothing_in_a_trace_without_spans():
    ev = [e for e in _events() if e["cat"] != "user_annotation"
          or e["name"] == "portbench.step"]
    for name in READERS:
        assert manifest.reader(name)(_ctx(ev)) is None, name
    assert set(spans.device_us_by_instruction(ev)) == {None}


def test_the_readers_are_the_serve_cells_alone():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    for w in bench["workloads"]:
        per = {m["name"] for m in manifest.cell_metrics(bench, w["name"])[1]}
        assert (set(READERS) <= per) == (w["name"] == SERVE)
        assert not (set(READERS) & per) or w["name"] == SERVE


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_a_program_span_of_a_named_layer(name):
    (m,) = [m for m in manifest.load()["per_layer"] if m["name"] == name]
    assert m["source"] == "program_span" and m["moves"] == "latency_p95_ms"
    assert m["layer"] in ("serving (serve_cnn/service.py)",
                          "program loop (deploy/executor.py)")


def test_the_ports_spans_are_what_the_readers_read():
    """A traced toy serve run on the CPU: every step the port served is one
    ``serve.step`` holding the five children the readers read."""
    cell = toy.cell("mobilenet_v1_224", "serve_b16_poisson",
                    check.limits(SERVE))
    cfg, cpu = cell.config, torch.device("cpu")
    net = network.layers(cfg)
    sched = network.schedule(net, cfg["levels"], None)
    w = wts.draw(net, cfg["weights"], cfg["levels"], 5, cpu)
    out = harness.run_open(cell, net, w, sched, 5, 0.6, True, cpu, time.perf_counter(),
                           False)
    ev = out["ctx"].events
    sp = spans.annotations(ev)
    steps = spans.named(sp, spans.STEP)
    assert len(steps) == len(spans.named(sp, "portbench.step")) > 0
    for step in steps:
        kids = [e["name"] for e in spans.inside(step, sp) if e["name"] in spans.STEP_CHILDREN]
        assert kids == list(spans.STEP_CHILDREN)
    for name in ("serve.assemble", "serve.h2d", "executor.execute", "serve.screen"):
        assert spans.per_step_ms(ev, name) > 0
    self_ms = spans.step_self_ms(ev)
    assert 0 <= self_ms < np.mean(spans.step_ms(ev))
