"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` takes the device it is given and never looks for a card
itself (``run.py`` does), so the tests drive a whole run on the CPU at a
toy size, with faults planted under ``port.execute``.  On the CPU the
timings mean nothing and ``run.py`` never prints them.

Closed loop: calls are issued back to back with no host sync; a CUDA event
after each call marks its end, and a call counts when its end falls inside
the window on the card's clock.  Open loop: the generator submits every
request that is due, then calls ``CNNService.step()``; a request's latency
runs from its due time to the return of the step that answered it.  Traced
runs (``trace=True``) report per-layer metrics instead, over a window of
the traffic's ``trace_seconds`` under ``torch.profiler``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, devtrace, manifest, network, port, reference, traffic
from portbench import weights as wts

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Marks:
    """Instants on the device's timeline: CUDA events on a card, the host
    clock on the CPU (where every call has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def now(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads (``portbench/metrics/``)."""

    events: list
    split: dict | None
    net: list
    sched: list
    batch: int
    calls: int                      # port executes inside the traced window
    serve_rows: list | None = None  # per step: assemble_h2d_ms, execute_ms, screen_d2h_ms


class GCPauses:
    """Pauses of the garbage collector while it is installed: ``settle()``
    collects and freezes what set-up made (so a full collection in the
    window scans only what the window made, as in a server long after its
    start), then every collection is timed until ``report()``."""

    def __init__(self):
        self.pauses: list[tuple[int, float]] = []
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def settle(self) -> None:
        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._cb)

    def report(self) -> str:
        gc.callbacks.remove(self._cb)
        gc.unfreeze()
        full = [t for g, t in self.pauses if g == 2]
        longest = max((t for _, t in self.pauses), default=0.0)
        return (f"garbage collector in the window: {len(self.pauses)} collections, "
                f"{len(full)} full, longest {longest * 1e3:.4f} ms")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------- closed ---
def rate(done_ms: list[float], batch: int, window_s: float) -> float:
    """Images per second of the calls whose end falls inside the window."""
    return sum(ms <= window_s * 1e3 for ms in done_ms) * batch / window_s


def closed_loop(program, ring, m_active, seconds: float, keep: set, keep_last: int,
                marks: Marks, span) -> dict:
    """Calls back to back over the ring for ``seconds`` of host time."""
    kept, last, ends = {}, collections.deque(maxlen=keep_last), []
    start = marks.now()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        with span("portbench.execute"):
            y = port.execute(program, ring[i % len(ring)], m_active)
        ends.append(marks.now())
        if i in keep:
            kept[i] = y
        last.append((i, y))
        i += 1
    marks.sync()
    kept.update(last)
    return {"calls": i, "done_ms": [marks.ms(start, e) for e in ends], "kept": kept}


def run_closed(cell, net, w, sched, seed, seconds, trace, device, t_start, control):
    tr = cell.traffic
    batch, ring_n = tr["batch"], tr["ring"]
    program = port.compile_program(cell.config, net, w, batch, device)
    hwc = tuple(cell.config["input_hwc"])
    ring = [wts.images((batch,) + hwc, seed, 10 + r, device) for r in range(ring_n)]
    marks = Marks(device)
    marks.sync()
    log(f"set-up: weights, compile, inputs {time.perf_counter() - t_start:.4f} s")
    for x in ring:                       # warm the cell's one shape
        port.execute(program, x, tr["m_active"])
    marks.sync()
    keep = traffic.kept_calls(seed, tr["keep_first"], tr["keep_sampled"])
    window = min(seconds, tr["trace_seconds"]) if trace else seconds
    pauses = GCPauses()
    pauses.settle()
    setup_s = time.perf_counter() - t_start
    out = {"setup_s": setup_s, "window_s": window, "ctx": None}
    if trace:
        with devtrace.Traced(_trace_path()) as t:
            loop = closed_loop(program, ring, tr["m_active"], window, keep,
                               tr["keep_last"], marks, torch.profiler.record_function)
        out["ctx"] = TraceContext(events=t.events, split=devtrace.device_split(t.events),
                                  net=net, sched=sched, batch=batch, calls=loop["calls"])
    else:
        loop = closed_loop(program, ring, tr["m_active"], window, keep, tr["keep_last"],
                           marks, contextlib.nullcontext)
    log(pauses.report())
    out["memory_peak_bytes"] = _peak(device)
    out["attempted"] = loop["calls"] * batch
    out["failed"] = 0
    out["metrics"] = {"images_per_s": rate(loop["done_ms"], batch, window)}
    log(f"closed loop: {loop['calls']} calls of {batch} issued, "
        f"{round(out['metrics']['images_per_s'] * window / batch)} ended inside the "
        f"{window} s window")
    kept = loop["kept"]
    del program, loop

    def compare(ref_fn):
        worst = 0.0
        for r in range(ring_n):
            ys = [y for i, y in kept.items() if i % ring_n == r]
            if ys:
                ref = ref_fn(ring[r])
                worst = max(worst, max(check.rel_err(y, ref) for y in ys))
        return worst

    out["compared"] = len(kept) * batch
    out["numbers"] = {"rel_err": compare(lambda x: reference.forward(net, w, x, sched))}
    if control:
        out["control"] = {"rel_err": max(
            check.rel_err(reference.forward(net, w, x, sched, tf32=True),
                          reference.forward(net, w, x, sched)) for x in ring)}
    return out


# ------------------------------------------------------------------ open ---
class Answers:
    """What the open loop keeps of each request due in the window, in flat
    arrays, so that the window leaves no object per request behind for the
    garbage collector to walk: when it was answered, how it left
    (``PENDING``, ``DONE``, ``SHED``, ``FAILED``), at which schedule, and
    its logits."""

    PENDING, DONE, SHED, FAILED = 0, 1, 2, 3

    def __init__(self, n: int, classes: int):
        self.done_at = np.full(n, math.inf)
        self.state = np.zeros(n, np.int8)
        self.sched = np.full(n, -1, np.int32)
        self.logits = np.zeros((n, classes), np.float32)
        self.schedules: list[tuple[int, ...]] = []
        self._in_flight: dict[int, int] = {}     # request id -> index

    def submitted(self, k: int, req) -> None:
        if req.status == "shed":
            self.state[k] = self.SHED
        else:
            self._in_flight[req.id] = k

    def finished(self, req, t: float) -> None:
        k = self._in_flight.pop(req.id, None)
        if k is None:          # a request of the warm-up
            return
        if req.status == "done":
            sched = tuple(req.m_schedule)
            if sched not in self.schedules:
                self.schedules.append(sched)
            self.state[k], self.done_at[k] = self.DONE, t
            self.sched[k] = self.schedules.index(sched)
            self.logits[k] = req.logits.numpy()
        else:
            self.state[k] = self.SHED if req.status == "shed" else self.FAILED


def open_loop(svc, pool, due, idx, seconds: float, drain_s: float, classes: int,
              on_step=None) -> dict:
    """Submit each request when due, step while the queue holds any; after
    the window, step until every request has left or ``drain_s`` passed."""
    n = due.size
    answers, late = Answers(n, classes), np.zeros(n)
    backlog = None
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        if backlog is None and now >= seconds:
            backlog = len(svc.queue) + int(np.sum(due[i:] < seconds))
        while i < n and due[i] <= now:
            answers.submitted(i, svc.submit(pool[idx[i]]))
            late[i] = now - due[i]
            i += 1
        if svc.queue:
            finished = on_step(svc) if on_step else svc.step()
            t = time.perf_counter() - t0
            for r in finished:
                answers.finished(r, t)
        elif i < n:
            wait = due[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
        else:
            break
        if now > seconds + drain_s:
            break
    lat = np.where(answers.state == Answers.DONE, answers.done_at - due, math.inf)
    return {"answers": answers, "latency_s": lat.tolist(), "late_s": late,
            "backlog": backlog or 0,
            "done_in_window": int(np.sum(answers.done_at <= seconds))}


def run_open(cell, net, w, sched, seed, seconds, trace, device, t_start, control,
             offered_per_s=None):
    tr = cell.traffic
    svc_spec = tr["service"]
    program = port.compile_program(cell.config, net, w, svc_spec["batch_size"], device,
                                   golden=bool(svc_spec.get("selftest_every")))
    hwc, classes = tuple(cell.config["input_hwc"]), cell.config["classes"]
    pool = wts.images((tr["pool"],) + hwc, seed, 2, device).cpu().numpy()
    log(f"set-up: weights, compile, inputs {time.perf_counter() - t_start:.4f} s")
    window = min(seconds, tr["trace_seconds"]) if trace else seconds
    arr = dict(tr["arrivals"])
    if offered_per_s is not None:
        arr["phases"] = [dict(p, rate_per_s=offered_per_s) for p in arr["phases"]]
    due, idx = traffic.arrivals(arr, window, seed, tr["pool"])
    steps, current = [], {}

    marks = Marks(device)

    def timed_execute(prog, x, m_active):
        current["exec0"] = marks.now()
        y = port.execute(prog, x, m_active)
        current["exec1"] = marks.now()
        return y

    def timed_step(svc):
        current.clear()
        with torch.profiler.record_function("portbench.step"):
            start = marks.now()
            finished = svc.step()
            end = marks.now()
        if "exec1" in current:
            steps.append((start, current["exec0"], current["exec1"], end))
        return finished

    svc = port.service(program, svc_spec, execute_fn=timed_execute if trace else None)
    bs = svc_spec["batch_size"]
    for k in range(tr["warm_steps"]):    # warm the cell's one shape
        for j in range(bs):
            svc.submit(pool[(k * bs + j) % tr["pool"]])
        svc.drain()
    marks.sync()
    pauses = GCPauses()
    pauses.settle()
    setup_s = time.perf_counter() - t_start
    out = {"setup_s": setup_s, "window_s": window, "ctx": None}
    drain = tr["drain_seconds"]
    if trace:
        # the split is read by events in a first part of the window; the
        # device trace in a second part, under a profiler started between
        # the two (starting one takes seconds)
        split_s = window - tr["profile_seconds"]
        first = due < split_s
        parts = [(open_loop(svc, pool, due[first], idx[first], split_s, drain, classes,
                            timed_step), idx[first])]
        marks.sync()
        rows = [{"assemble_h2d_ms": marks.ms(s, e0), "execute_ms": marks.ms(e0, e1),
                 "screen_d2h_ms": marks.ms(e1, e)} for s, e0, e1, e in steps]
        steps.clear()
        with devtrace.Traced(_trace_path()) as t:
            parts.append((open_loop(svc, pool, due[~first] - split_s, idx[~first],
                                    window - split_s, drain, classes, timed_step),
                          idx[~first]))
        out["ctx"] = TraceContext(events=t.events, split=devtrace.device_split(t.events),
                                  net=net, sched=sched, batch=bs, calls=len(steps),
                                  serve_rows=rows)
    else:
        parts = [(open_loop(svc, pool, due, idx, window, drain, classes), idx)]
    log(pauses.report())
    out["memory_peak_bytes"] = _peak(device)
    lat = [v for loop, _ in parts for v in loop["latency_s"]]
    out["attempted"] = len(lat)
    out["failed"] = sum(math.isinf(v) for v in lat)
    out["metrics"] = {"latency_p95_ms": check.p95(lat) * 1e3}
    last = parts[-1][0]
    out["sweep"] = {"offered_per_s": len(lat) / window,
                    "done_in_window": last["done_in_window"], "backlog": last["backlog"],
                    "p50_ms": float(np.median(lat)) * 1e3 if lat else math.inf,
                    "p95_ms": check.p95(lat) * 1e3}
    late = np.concatenate([loop["late_s"] for loop, _ in parts]) * 1e3
    if late.size:
        log(f"open loop: {late.size} requests due in {window} s; generator late by "
            f"p50 {np.median(late):.4f} ms, p99 {np.percentile(late, 99):.4f} ms, "
            f"max {late.max():.4f} ms; backlog at the close {last['backlog']}")
    stats = svc.stats
    log(f"service: completed {stats['completed']}, shed {stats['shed']}, "
        f"failed batches {stats['exec_failed_batches']}, batches {stats['batches']}")
    answered = [(loop["answers"], k) for loop, k in parts]
    del program, svc, parts, last

    def pool_ref(s, tf32=False):
        block = tr["reference_block"]
        x = torch.from_numpy(pool)
        return torch.cat([reference.forward(net, w, x[a:a + block].to(device), list(s),
                                            tf32=tf32)
                          for a in range(0, len(pool), block)])

    worst, control_err, lost, compared, refs = 0.0, 0.0, 0, 0, {}
    for answers, k in answered:
        lost += int(np.sum((answers.state == Answers.PENDING)
                           | (answers.state == Answers.FAILED)))
        compared += int(np.sum(answers.state == Answers.DONE))
        for j, sched in enumerate(answers.schedules):
            if sched not in refs:
                refs[sched] = pool_ref(sched)
                if control:
                    control_err = max(control_err, check.rel_err(
                        pool_ref(sched, tf32=True), refs[sched]))
            served = np.flatnonzero((answers.state == Answers.DONE) & (answers.sched == j))
            rows = torch.as_tensor(k[served], device=refs[sched].device)
            worst = max(worst, check.rel_err(torch.from_numpy(answers.logits[served]),
                                             refs[sched][rows]))
    out["compared"] = compared
    out["numbers"] = {"rel_err": worst, "lost": lost}
    if control:
        out["control"] = {"rel_err": control_err}
    return out


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _trace_path() -> Path:
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    return Path(path)


# ------------------------------------------------------------------- run ---
def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, control: bool = False,
             offered_per_s: float | None = None) -> dict:
    """Set the cell up from ``seed`` on ``device``, run its window, check
    the answers, and return the result (``result`` is the JSON line).
    ``control`` also reads the control on the same inputs;
    ``offered_per_s`` replaces an open loop's rates (the knee sweep)."""
    cfg = cell.config
    net = network.layers(cfg)
    sched = network.schedule(net, cfg["levels"], cell.traffic.get("m_active"))
    log(f"set-up: imports and kernels {time.perf_counter() - t_start:.4f} s")
    w = wts.draw(net, cfg["weights"], cfg["levels"], seed, device)
    loop = cell.traffic["loop"]
    if loop == "closed":
        out = run_closed(cell, net, w, sched, seed, seconds, trace, device, t_start,
                         control)
    elif loop == "open":
        out = run_open(cell, net, w, sched, seed, seconds, trace, device, t_start,
                       control, offered_per_s)
    else:
        raise ValueError(f"unknown loop {loop!r}")
    numbers = {k: {"value": v, "limit": cell.limits[k]} for k, v in out["numbers"].items()}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        metrics = {}
        ctx = out["ctx"]
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(ctx) if ctx is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        result["metrics"] = metrics
    else:
        wanted = {m["name"] for m in cell.end_to_end}
        values = dict(out["metrics"], setup_s=out["setup_s"])
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in values.items() if k in wanted}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace and out["ctx"] is not None and out["ctx"].split is not None:
        split = out["ctx"].split
        dev["busy_s"] = split["busy_us"] * 1e-6
        dev["window_s"] = split["window_us"] * 1e-6
        result["breakdown"] = devtrace.breakdown(out["ctx"].events)
    result["device"] = dev
    result["check"] = numbers
    return {"result": result, "compared": out["compared"], "control": out.get("control"),
            "sweep": out.get("sweep"), "setup_s": out["setup_s"]}
