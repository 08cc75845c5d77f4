"""``BENCHMARK.json`` and the files it names.

A cell is found by name: its workload entry names a configuration (whose
``file`` is ``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); its per-layer metrics are readers
``portbench/metrics/<metric>.py`` and its limits
``portbench/limits/<workload>.json``.  Adding a cell, a configuration or a
metric adds files and entries and edits none.  ``validate`` checks the
manifest against the benchmark's contract as far as a file can show it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

from portbench import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
_UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
_PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
_TOP = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer")
_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass
class Cell:
    """One workload with everything its run reads."""

    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, workload: str) -> bool:
    """Whether a cell reports an end-to-end metric."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics of one cell: a per-layer metric
    without ``workloads`` goes to every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s manifest, read from its files."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e, per = cell_metrics(bench, workload)
    return Cell(name=workload,
                config=json.loads((root / config["file"]).read_text()),
                traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                                   .read_text()),
                end_to_end=e2e, per_layer=per, limits=check.limits(workload))


def reader(metric: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _line(s, n=200) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def validate(bench: dict, root: Path = ROOT) -> list[str]:
    """Every breach of the contract that the files show; empty when none."""
    err = []
    if set(bench) != set(_TOP):
        err.append(f"top-level keys {sorted(bench)}")
    cmd, paths = bench.get("command", []), bench.get("paths", [])
    if not (1 <= len(cmd) <= 32) or not all(_line(w) for w in cmd):
        err.append("command")
    if not (1 <= len(paths) <= 16) or not all(
            _PATH.match(p) and not p.startswith("/") and ".." not in p for p in paths):
        err.append("paths")
    if not (isinstance(bench.get("run_seconds"), int) and 1 <= bench["run_seconds"] <= 51):
        err.append("run_seconds")
    names = set()
    for group, keys in _KEYS.items():
        entries = bench.get(group, [])
        if not entries:
            err.append(f"{group} is empty")
        for e in entries:
            extra = set(e) - keys - ({"workloads"} if group in ("end_to_end", "per_layer")
                                     else set())
            if set(e) & keys != keys or extra:
                err.append(f"{group} {e.get('name')}: keys {sorted(e)}")
            if not _NAME.match(str(e.get("name", ""))):
                err.append(f"{group}: bad name {e.get('name')!r}")
            if (group, e.get("name")) in names:
                err.append(f"{group}: {e['name']} twice")
            names.add((group, e.get("name")))
    configs = {c["name"]: c for c in bench.get("configs", [])}
    for c in configs.values():
        if not _line(c["source"]) or not _line(c["why"]) or len(c["reduced"]) > 16:
            err.append(f"config {c['name']}: source, why or reduced")
        if not (root / c["file"]).is_file() or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            err.append(f"config {c['name']}: file {c['file']} missing or outside paths")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    pairs = set()
    for w in cells.values():
        if w["config"] not in configs:
            err.append(f"workload {w['name']}: unknown config {w['config']}")
        if not _NAME.match(w["traffic"]) or not (
                HERE / "traffic" / f"{w['traffic']}.json").is_file():
            err.append(f"workload {w['name']}: traffic file missing")
        if not (HERE / "limits" / f"{w['name']}.json").is_file():
            err.append(f"workload {w['name']}: limits file missing")
        if w["chips"] not in (1, 4) or not _line(w["why"]):
            err.append(f"workload {w['name']}: chips or why")
        if (w["config"], w["traffic"]) in pairs:
            err.append(f"workload {w['name']}: config and traffic used twice")
        pairs.add((w["config"], w["traffic"]))
    if set(configs) - {w["config"] for w in cells.values()}:
        err.append("a configuration no cell uses")
    four = sum(w["chips"] == 4 for w in cells.values())
    if four > max(1, len(cells) // 4):
        err.append(f"{four} cells on four chips")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e or e2e["setup_s"].get("bound", 1) > 0.25:
        err.append("setup_s missing or its bound above 0.25")
    layers = {}
    for m in list(e2e.values()) + bench.get("per_layer", []):
        if not _UNIT.match(m.get("unit", "")) or m.get("better") not in ("lower", "higher"):
            err.append(f"metric {m['name']}: unit or better")
        if m.get("source") not in SOURCES:
            err.append(f"metric {m['name']}: source")
        if any(w not in cells for w in m.get("workloads", [])):
            err.append(f"metric {m['name']}: unknown workload")
    for m in e2e.values():
        if m["source"] not in ("host_clock", "device_trace"):
            err.append(f"end-to-end {m['name']}: source {m['source']}")
        if not (0.01 <= m.get("bound", 0) <= 0.25):
            err.append(f"end-to-end {m['name']}: bound {m.get('bound')}")
    for m in bench.get("per_layer", []):
        if m["moves"] not in e2e or not _line(m["layer"]):
            err.append(f"per-layer {m['name']}: moves or layer")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            err.append(f"per-layer {m['name']}: no reader")
        for w in m.get("workloads", cells):
            if not reports(e2e.get(m["moves"], {"workloads": []}), w):
                err.append(f"per-layer {m['name']}: {w} does not report {m['moves']}")
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if ("_roofline" in m["name"] or "mfu" in m["name"]) and m["unit"] != "%":
            err.append(f"per-layer {m['name']}: a share of a peak is in %")
    for w in cells:
        got, per = cell_metrics(bench, w)
        if "setup_s" not in {m["name"] for m in got} or len(got) < 2 or not per:
            err.append(f"workload {w}: needs setup_s, another end-to-end metric "
                       f"and a per-layer metric")
    if any(len(v) > 1 for v in layers.values()):
        err.append(f"layers spelt two ways: {[v for v in layers.values() if len(v) > 1]}")
    return err
