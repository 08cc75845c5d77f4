"""Toy cells for the CPU tests: the benchmark's own configurations and
traffic shrunk to a size a test run holds (MobileNet at an eighth of its
widths on 32x32 images; CNN-A as it is, in batches of a few images)."""
from __future__ import annotations

import copy
import json

from portbench import manifest

CONFIGS = manifest.HERE / "configs"
TRAFFIC = manifest.HERE / "traffic"


def config(name: str) -> dict:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    if name == "mobilenet_v1_224":
        cfg["input_hwc"] = [32, 32, 3]
        for layer in cfg["layers"]:
            if "out" in layer and layer["kind"] == "conv":
                layer["out"] = max(8, layer["out"] // 8)
        cfg["layers"][-1]["out"] = cfg["classes"] = 10
    return cfg


def traffic(name: str) -> dict:
    tr = json.loads((TRAFFIC / f"{name}.json").read_text())
    if tr["loop"] == "closed":
        tr.update(batch=2, ring=2, keep_first=4, keep_sampled=2, keep_last=2)
    else:
        tr["service"] = dict(tr["service"], batch_size=4)
        tr["arrivals"] = {"phases": [{"rate_per_s": 400.0, "seconds": 0.5}]}
        tr.update(pool=8, warm_steps=1, reference_block=4, profile_seconds=0.2)
    return tr


def cell(config_name: str, traffic_name: str, limits=None) -> manifest.Cell:
    limits = limits or {"rel_err": 1e-4, "lost": 0}
    return manifest.Cell(name=f"{config_name}.{traffic_name}", config=config(config_name),
                         traffic=traffic(traffic_name), end_to_end=[
                             {"name": "images_per_s", "unit": "images/s"},
                             {"name": "latency_p95_ms", "unit": "ms"},
                             {"name": "setup_s", "unit": "s"}],
                         per_layer=[], limits=copy.deepcopy(limits))
