#!/usr/bin/env python3
"""What the port's spans show on one CUDA card, and what they cost.

    python3 tools/torch_span_report.py trace --workload <cell> --seed <n>
    python3 tools/torch_span_report.py cost [--src DIR] [--against DIR] [--tag NAME]

``trace`` runs one cell of ``BENCHMARK.json`` traced, as
``portbench/run.py --trace 1`` does, and reports from its window: the
cell's per-layer metrics; device time by the ``executor.<instr>`` span
that launched it (``portbench/spans.py``), per call and as a share of the
window's device time, beside the layer's share of the MACs; for an open
loop, the step split by the port's spans, the traced step's mean beside
the untraced steps' (the benchmark's CUDA events over the first part of
the window) and the spans per step; and the idle-gap breakdown.  Written
to ``chiprun_out/span_report_<cell>.json``.

``cost`` imports ``repro_torch`` from ``--src`` (default: this checkout's
``src/``) and times on the host: one span with no profiler (where the
tree has ``repro_torch.tracing``), a bare ``record_function`` with no
profiler, one span under a recording profiler, and one MobileNetV1-224
batch-16 ``execute`` with no profiler and under one (median of 1,000
calls, a sync every 10 outside the timing).  With ``--against DIR`` it
also loads that tree's ``repro_torch/deploy/executor.py`` beside this
one's and times the two executors in turns, 10 calls each for 400 rounds,
with no profiler.  Written to ``chiprun_out/span_cost_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out"
SERVE = "mobilenet_v1_224.serve_b16_poisson"


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def trace_report(cell, seed: int, device) -> dict:
    """One traced window of ``cell`` and what the port's spans say of it."""
    import numpy as np

    from portbench import devtrace, harness, manifest, network, port, spans
    from portbench import weights as wts

    cfg = cell.config
    net = network.layers(cfg)
    sched = network.schedule(net, cfg["levels"], cell.traffic.get("m_active"))
    w = wts.draw(net, cfg["weights"], cfg["levels"], seed, device)
    run = harness.run_closed if cell.traffic["loop"] == "closed" else harness.run_open
    out = run(cell, net, w, sched, seed, 1e9, True, device, time.perf_counter(), False)
    ctx = out["ctx"]
    ev = ctx.events
    metrics = {m["name"]: manifest.reader(m["name"])(ctx) for m in cell.per_layer}
    by = spans.device_us_by_instruction(ev)
    total = sum(by.values()) or 1.0
    macs = {f"executor.{layer.name}": layer.macs for layer in net}
    all_macs = sum(macs.values())
    rows = [{"span": name or "(no instruction)", "us_per_call": us / max(ctx.calls, 1),
             "device_share": us / total, "macs_share": macs.get(name, 0) / all_macs}
            for name, us in sorted(by.items(), key=lambda kv: -kv[1])]
    report = {"workload": cell.name, "seed": seed, "card": card(), "calls": ctx.calls,
              "repro_torch": str(port.ORIGIN),
              "metrics": metrics, "device_us": total,
              "instruction_share": sum(us for n, us in by.items() if n) / total,
              "by_instruction": rows, "breakdown": devtrace.breakdown(ev)}
    if ctx.split is not None:
        report["window_us"], report["busy_us"] = ctx.split["window_us"], ctx.split["busy_us"]
    if cell.traffic["loop"] == "open":
        sp = spans.annotations(ev)
        steps = spans.named(sp, spans.STEP)
        untraced = [sum(r.values()) for r in ctx.serve_rows]
        report["serve"] = {
            "steps": len(steps),
            "step_ms_traced_mean": float(np.mean(spans.step_ms(ev))) if steps else None,
            "harness_step_ms_traced_mean": float(np.mean(
                [float(e["dur"]) * 1e-3 for e in spans.named(sp, "portbench.step")])),
            "step_ms_untraced_mean": float(np.mean(untraced)) if untraced else None,
            "untraced_split_ms": {k: float(np.mean([r[k] for r in ctx.serve_rows]))
                                  for k in (ctx.serve_rows or [{}])[0]},
            "split_ms": {n: spans.per_step_ms(ev, n) for n in spans.STEP_CHILDREN},
            "self_ms": spans.step_self_ms(ev),
            "spans_per_step": (sum(len(spans.inside(s, sp)) + 1 for s in steps)
                               / max(len(steps), 1)),
        }
    return report


def cost_report(src: Path, device, against: Path | None = None) -> dict:
    """Host µs of a span and of a MobileNetV1-224 batch-16 ``execute``, with
    the port imported from ``src``; with ``against``, that tree's executor
    beside this one's, in turns."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import manifest, network, port
    from portbench import weights as wts
    from repro_torch.deploy import executor

    def per_call_us(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def host_us(fn, n=1000, sync_every=10):
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
            if i % sync_every == sync_every - 1:
                torch.cuda.synchronize(device)
        q = statistics.quantiles(times, n=4)
        return {"median": statistics.median(times), "q1": q[0], "q3": q[2],
                "mean": statistics.fmean(times)}

    report = {"src": str(src), "card": card(), "repro_torch": str(port.ORIGIN)}
    try:
        from repro_torch import tracing
    except ImportError:
        tracing = None

    def bare():
        with torch.profiler.record_function("cost.bare"):
            pass
    report["record_function_off_us"] = per_call_us(bare, 20_000)
    if tracing is not None:
        def gated():
            with tracing.span("cost.span"):
                pass
        report["span_off_us"] = per_call_us(gated, 200_000)
    cfg = manifest.cell(SERVE, ROOT).config
    net = network.layers(cfg)
    w = wts.draw(net, cfg["weights"], cfg["levels"], 11, device)
    program = port.compile_program(cfg, net, w, 16, device)
    x = wts.images((16,) + tuple(cfg["input_hwc"]), 11, 10, device)
    for _ in range(20):
        executor.execute(program, x)
    torch.cuda.synchronize(device)
    report["execute_b16_host_us_off"] = host_us(lambda: executor.execute(program, x))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        if tracing is not None:
            report["span_on_us"] = per_call_us(gated, 5_000)
        report["record_function_on_us"] = per_call_us(bare, 5_000)
        report["execute_b16_host_us_on"] = host_us(lambda: executor.execute(program, x),
                                                   n=300)
    torch.cuda.synchronize(device)
    if against is not None:
        path = against / "repro_torch" / "deploy" / "executor.py"
        spec = importlib.util.spec_from_file_location("against_executor", path)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        if not torch.equal(other.execute(program, x), executor.execute(program, x)):
            raise SystemExit("torch_span_report: the two executors disagree")
        rounds = {"this": [], "against": []}
        for r in range(400):
            pair = [("this", executor), ("against", other)]
            for name, mod in (pair if r % 2 == 0 else pair[::-1]):
                rounds[name].append(host_us(lambda m=mod: m.execute(program, x), n=10)["median"])
        ratio = [a / b for a, b in zip(rounds["this"], rounds["against"])]
        report["ab_execute_b16_host_us_off"] = {
            "against": str(path), "rounds": rounds,
            "this_median": statistics.median(rounds["this"]),
            "against_median": statistics.median(rounds["against"]),
            "ratio_quartiles": statistics.quantiles(ratio, n=4),
            "this_faster_rounds": sum(q < 1 for q in ratio)}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("trace", "cost"))
    ap.add_argument("--workload", default=SERVE)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--against", default=None)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path[0:0] = [str(src), str(ROOT)]

    import torch

    if not torch.cuda.is_available():
        print("torch_span_report: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench import manifest, port
    port.load_kernels()
    device = torch.device("cuda", 0)
    if args.what == "trace":
        report = trace_report(manifest.cell(args.workload, ROOT), args.seed, device)
        path = OUT / f"span_report_{args.workload}.json"
    else:
        report = cost_report(src, device, Path(args.against).resolve() if args.against
                             else None)
        path = OUT / f"span_cost_{args.tag}.json"
    OUT.mkdir(exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    brief = {k: v for k, v in report.items() if k not in ("breakdown", "by_instruction")}
    brief.get("ab_execute_b16_host_us_off", {}).pop("rounds", None)
    print(json.dumps(brief), flush=True)
    for row in report.get("by_instruction", [])[:40]:
        print(f"  {row['span']:<22} {row['us_per_call']:10.2f} us/call "
              f"{100 * row['device_share']:6.2f} % device {100 * row['macs_share']:6.2f} % MACs",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
