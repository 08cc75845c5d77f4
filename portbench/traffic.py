"""The one generator every traffic file is read by.

A traffic file (``portbench/traffic/<name>.json``) is data.  ``"loop"``
says which of two drivers runs it:

``closed``  offline batches back to back: ``batch`` images per call, a
            ``ring`` of distinct batches drawn on the device, ``m_active``
            (null = every level, an int, or one entry per layer).
``open``    independent requests to a ``CNNService`` (its ``service``
            block): arrivals from ``arrivals.phases``, each phase a rate
            and a length, cycled; each request one image of a host
            ``pool`` picked by index.

Arrivals of a phase are a Poisson process conditioned on its count:
``round(rate * length)`` instants uniform in the phase, sorted.  So every
seed offers the same number of requests, in other places.
"""
from __future__ import annotations

import numpy as np

LOOPS = ("closed", "open")


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


def arrivals(spec: dict, seconds: float, seed: int, pool: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """(due times in seconds from the window's start, pool index of each)
    for every request due in ``[0, seconds)``."""
    r = rng(seed, 3)
    phases = spec["phases"]
    if not phases or any(p["seconds"] <= 0 or p["rate_per_s"] < 0 for p in phases):
        raise ValueError(f"arrival phases need positive lengths: {phases}")
    times, t, i = [], 0.0, 0
    while t < seconds:
        p = phases[i % len(phases)]
        length = min(p["seconds"], seconds - t)
        n = int(round(p["rate_per_s"] * length))
        times.append(t + np.sort(r.uniform(0.0, length, n)))
        t += length
        i += 1
    due = np.concatenate(times)
    return due, r.integers(0, pool, due.size)


def offered_rate(spec: dict) -> float:
    """Mean rate over one cycle of the phases, requests per second."""
    phases = spec["phases"]
    return (sum(p["rate_per_s"] * p["seconds"] for p in phases)
            / sum(p["seconds"] for p in phases))


def kept_calls(seed: int, first: int, n: int) -> set[int]:
    """Indices of ``n`` calls among the first ``first`` of a closed loop,
    drawn from the seed, whose outputs the check keeps."""
    return set(rng(seed, 4).choice(first, size=min(n, first), replace=False).tolist())
