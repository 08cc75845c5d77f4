"""The numbers that decide ``correct``, and the statistics of a window.

``rel_err`` is the comparison of a cell's answers with the reference: per
image, the largest gap between a logit and the reference's, over the
largest reference logit of that image; the cell reads the largest over
every answer it compares.  A non-finite answer reads infinite.  Each cell's
limit, and the readings it was set from, are in
``portbench/limits/<workload>.json``.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent / "limits"


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of max|y - ref| / max|ref| (inf where y is not finite)."""
    y, ref = y.to(ref.device, torch.float32), ref.to(torch.float32)
    gap = (y - ref).abs()
    gap = torch.where(torch.isfinite(y), gap, torch.full_like(gap, math.inf))
    scale = ref.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float((gap.amax(dim=-1) / scale).max())


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank (a missing answer is ``inf``)."""
    if not values:
        return math.inf
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def limits(workload: str) -> dict:
    """``{number: limit}`` of a workload, from its limits file."""
    data = json.loads((LIMITS / f"{workload}.json").read_text())
    return {name: entry["limit"] for name, entry in data["numbers"].items()}
