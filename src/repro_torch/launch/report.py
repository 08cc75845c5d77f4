"""The dry run's three tables from its records (counterpart of
``repro/launch/report.py``, in its format).

The columns the JAX tables name "HLO" hold the port's counted eager step
(``launch/cost_analysis.py``); "adj. memory s" stays empty: the port's
records carry no dequantization artifact (``launch/hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.launch.report > experiments/torch_tables.md
"""
from __future__ import annotations

import glob
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "torch_dryrun")


def _records() -> list:
    out = []
    for p in sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def load(tag_filter=None):
    recs = []
    for r in _records():
        tag = r.get("tag", "")
        if tag_filter is None and tag:
            continue
        if tag_filter is not None and tag != tag_filter:
            continue
        recs.append(r)
    return recs


def _fmt_gb(x):
    return f"{x / 1e9:.2f}"


def dryrun_table():
    print("| arch | shape | mesh | status | args GB/dev | temp GB/dev "
          "| HLO GFLOP/dev | HLO GB/dev | wire GB/dev | collectives |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in load():
        if r["status"] == "skipped":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP"
                  f" (full attention, sub-quadratic required) | | | | | | |")
            continue
        mem = r.get("memory_stats", {})
        coll = r.get("collective_ops", {})
        coll_s = " ".join(f"{k}:{v}" for k, v in sorted(coll.items()))
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
              f"| {_fmt_gb(mem.get('argument_bytes', 0))} "
              f"| {_fmt_gb(mem.get('temp_bytes', 0))} "
              f"| {r['flops_per_device'] / 1e9:.0f} "
              f"| {_fmt_gb(r['bytes_per_device'])} "
              f"| {_fmt_gb(r['wire_bytes_per_device'])} "
              f"| {coll_s} |")


def roofline_table():
    print("| arch | shape | mesh | compute s | memory s | collective s "
          "| bound | roofline frac | 6ND/HLO |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in load():
        if r["status"] != "ok":
            continue
        step = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / step if step else 0.0
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
              f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
              f"| {r['collective_s']:.3f} | {r['bound']} | {frac:.3f} "
              f"| {r.get('model_flops_ratio', 0):.2f} |")


def perf_table():
    tagged = [r for r in _records() if r.get("tag")]
    base = {(r["arch"], r["shape"], r["mesh"]): r for r in load()}
    print("| cell | iteration | compute s | memory s | adj. memory s "
          "| collective s | bound | Δ dominant |")
    print("|---|---|---|---|---|---|---|---|")
    for r in tagged:
        key = (r["arch"], r["shape"], r["mesh"])
        b = base.get(key)
        if r["status"] != "ok":
            print(f"| {key[0]}/{key[1]} | {r['tag']} | ERROR: "
                  f"{r.get('error', '')[:60]} | | | | | |")
            continue
        dom = b["bound"] if b else "?"
        before = b[f"{dom}_s"] if b else 0
        after_key = ("adjusted_memory_s"
                     if dom == "memory" and "adjusted_memory_s" in r
                     else f"{dom}_s")
        after = r.get(after_key, r.get(f"{dom}_s", 0))
        delta = (1 - after / before) * 100 if before else 0
        adj = r.get("adjusted_memory_s")
        print(f"| {key[0]}/{key[1]} | {r['tag']} | {r['compute_s']:.3f} "
              f"| {r['memory_s']:.3f} | "
              f"{'' if adj is None else f'{adj:.3f}'} "
              f"| {r['collective_s']:.3f} | {r['bound']} "
              f"| {delta:+.0f}% on {dom} |")


if __name__ == "__main__":
    print("## Dry-run (generated)\n")
    dryrun_table()
    print("\n## Roofline (generated)\n")
    roofline_table()
    print("\n## Perf iterations (generated)\n")
    perf_table()
