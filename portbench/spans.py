"""The program's own spans in a traced window, and the arithmetic on them.

The port opens ``record_function`` spans while a profiler records
(``repro_torch.tracing``); the profiler's chrome trace carries them as
``user_annotation`` events on the host thread that opened them, on the
kernels' clock.  A span's children are the spans inside it on the same
thread; its self time is its length less the union of its children.  Device
time goes to an instruction by the launch that made it: each device span
is matched to its ``cudaLaunchKernel`` (or copy) by ``args.correlation``,
and the launch to the innermost ``executor.<instr>`` span over it.  A trace
of a program without spans reads as empty, never as an error; so does a
trace without the card's spans (a run on the CPU, where the benchmark
reports no time).
"""
from __future__ import annotations

import bisect

from portbench import devtrace

ANNOTATION = "user_annotation"
STEP = "serve.step"
STEP_CHILDREN = ("serve.assemble", "serve.h2d", "executor.execute", "serve.screen",
                 "serve.d2h")
EXECUTE = "executor.execute"
INSTR_PREFIX = "executor."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_EPS_US = 0.01   # the trace rounds times to the nanosecond


def _start(e) -> float:
    return float(e["ts"])


def _end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


def card_events(ctx) -> list:
    """The traced window's events where they hold the card's spans, else
    none."""
    return ctx.events if ctx.split is not None else []


def annotations(events: list) -> list[dict]:
    """The program's spans (and the benchmark's own), in start order."""
    return sorted((e for e in events if e.get("cat") == ANNOTATION), key=_start)


def named(spans: list, name: str) -> list[dict]:
    """The spans called ``name``, in the order of ``spans``."""
    return [e for e in spans if e["name"] == name]


def inside(parent: dict, spans: list) -> list[dict]:
    """The spans of ``spans`` (in start order) that lie within ``parent`` on
    its thread."""
    a, b = _start(parent) - _EPS_US, _end(parent) + _EPS_US
    lo = bisect.bisect_left(spans, a, key=_start)
    hi = bisect.bisect_right(spans, b, key=_start)
    return [e for e in spans[lo:hi] if e is not parent and _end(e) <= b
            and e.get("pid") == parent.get("pid") and e.get("tid") == parent.get("tid")]


def union_us(intervals) -> float:
    """The length of the union of ``(start, stop)`` intervals (µs)."""
    total, reach = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > reach:
            total += stop - max(start, reach)
            reach = stop
    return total


def self_us(parent: dict, children: list) -> float:
    """``parent``'s length less the part of it its children cover (µs)."""
    a, b = _start(parent), _end(parent)
    covered = union_us((max(a, _start(c)), min(b, _end(c))) for c in children
                       if _end(c) > a and _start(c) < b)
    return float(parent["dur"]) - covered


def step_ms(events: list) -> list[float]:
    """The length of each ``serve.step`` (ms)."""
    return [float(e["dur"]) * 1e-3 for e in named(annotations(events), STEP)]


def per_step_ms(events: list, name: str) -> float | None:
    """The spans called ``name`` summed inside each ``serve.step``, averaged
    over the steps (ms); None where the trace holds no step."""
    spans = annotations(events)
    steps = named(spans, STEP)
    if not steps:
        return None
    total = sum(float(e["dur"]) for s in steps for e in inside(s, spans) if e["name"] == name)
    return total * 1e-3 / len(steps)


def step_self_ms(events: list) -> float | None:
    """Each ``serve.step`` less the union of its five children, averaged over
    the steps (ms); None where the trace holds no step."""
    spans = annotations(events)
    steps = named(spans, STEP)
    if not steps:
        return None
    total = sum(self_us(s, [e for e in inside(s, spans) if e["name"] in STEP_CHILDREN])
                for s in steps)
    return total * 1e-3 / len(steps)


def device_us_by_instruction(events: list) -> dict:
    """Device time (µs) by the ``executor.<instr>`` span whose launch made it;
    device spans whose launch is under no such span, or is not in the
    trace, go under None.  An instruction's spans follow one another on
    their thread (they do not nest), so the launch's is the last one to
    start before it, if it is still open."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    instrs: dict[tuple, list[dict]] = {}
    for e in annotations(events):
        if e["name"].startswith(INSTR_PREFIX) and e["name"] != EXECUTE:
            instrs.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: dict = {}
    for k in events:
        if k.get("cat") not in devtrace.DEVICE_CATS:
            continue
        launch = launches.get(k.get("args", {}).get("correlation"))
        name = None
        if launch is not None:
            spans = instrs.get((launch.get("pid"), launch.get("tid")), [])
            i = bisect.bisect_right(spans, _start(launch), key=_start) - 1
            if i >= 0 and _start(launch) <= _end(spans[i]):
                name = spans[i]["name"]
        out[name] = out.get(name, 0.0) + float(k["dur"])
    return out
