"""The profiler's trace of a run's traced window, and what is read from it.

``device_split`` is a frozen copy of ``device_split()`` in
``chip_smoke.py`` (as of the port's bring-up): the window runs from the
first span, host or device, to the end of the last device span, and busy
time is the union of the device spans.  Here it returns None where the
trace holds no device span, in place of failing.
"""
from __future__ import annotations

import bisect
import json
import math
import os
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LONG_US = 10_000.0   # host spans longer than this are searched one by one


class Traced:
    """``with Traced(path) as t: ...`` runs the block under ``torch.profiler``
    (CPU and CUDA activity); afterwards ``t.events`` holds the chrome
    trace's spans and the file is removed."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.events: list[dict] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(str(self.path))
            try:
                events = json.loads(self.path.read_text())["traceEvents"]
            finally:
                os.unlink(self.path)
            self.events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        return False


def device_split(events: list) -> dict | None:
    """Device time by kernel name and the device's idle share over the
    window; None where the trace holds no device span."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not device:
        return None
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    busy, reach = 0.0, -math.inf
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in device):
        if stop > reach:
            busy += stop - max(start, reach)
            reach = stop
    window = reach - min(float(e["ts"]) for e in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_us": window, "busy_us": busy, "idle_share": 1.0 - busy / window,
            "device_us_by_name": dict(top)}


def device_events(events: list, pattern: str) -> list[dict]:
    """Device spans whose name contains ``pattern``."""
    return [e for e in events if e.get("cat") in DEVICE_CATS and pattern in e["name"]]


def _gaps(events: list) -> list[tuple[float, float]]:
    """Idle intervals of the device inside the window (µs)."""
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") in DEVICE_CATS)
    reach = min(float(e["ts"]) for e in events)
    gaps = []
    for start, stop in device:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, stop)
    return gaps


def _host_activity(host: list, starts: list, long: list, a: float, b: float) -> str:
    """The host span that best names what the host did in ``[a, b)``: of the
    spans overlapping it by at least half the largest overlap, the shortest."""
    lo = bisect.bisect_left(starts, a - _LONG_US)
    hi = bisect.bisect_left(starts, b)
    best = []
    for e in host[lo:hi] + long:
        s, d = float(e["ts"]), float(e["dur"])
        ov = min(b, s + d) - max(a, s)
        if ov > 0:
            best.append((ov, d, e["name"]))
    if not best:
        return "(no host span)"
    top = max(ov for ov, _, _ in best)
    return min((d, name) for ov, d, name in best if ov >= 0.5 * top)[1]


def breakdown(events: list, limit: int = 10, width: int = 100) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing meanwhile; seconds, at most ``limit`` each."""
    split = device_split(events) or {"device_us_by_name": {}}
    ops = [[name[:width], us * 1e-6]
           for name, us in list(split["device_us_by_name"].items())[:limit]]
    host = sorted((e for e in events if e.get("cat") in HOST_CATS),
                  key=lambda e: float(e["ts"]))
    long = [e for e in host if float(e["dur"]) > _LONG_US]
    host = [e for e in host if float(e["dur"]) <= _LONG_US]
    starts = [float(e["ts"]) for e in host]
    idle: dict[str, float] = {}
    for a, b in (_gaps(events) if split["device_us_by_name"] else []):
        name = _host_activity(host, starts, long, a, b)[:width]
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    gaps = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:limit]
    return {"device_ops": ops, "idle_gaps": gaps}
