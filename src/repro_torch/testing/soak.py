"""Soak harness: run a workload for thousands of steps and defend flat trends.

Port of ``repro/testing/soak.py`` with the same names, defaults,
tolerances and sampling, so a series that passes or fails ``assert_flat``
in one package does the same in the other (``tests/test_torch_soak_harness.py``
holds the two against each other).  The paper's claim is *sustained*
inference (§V), and the port's long-lived surfaces (the plan picks the
executor must never make, the loaded kernel libraries, live CUDA memory,
``Server``'s per-level configs, ``CNNService``'s hot reload) grow only
under continuous load; this harness makes such growth fail a test.

``run_soak`` drives a step closure ``steps`` times and samples, every
``sample_every`` steps:

  * **RSS** (``/proc/self/statm``, psutil fallback) — native leaks: host
    tensors, loaded libraries, allocator arenas;
  * **tracemalloc** current traced bytes — Python-level leaks (request
    lists, stats dicts, closure captures); torch's own allocations are not
    traced;
  * **per-step wall latency** (mean over the sample window) — steady-state
    slowdowns;
  * **gauges** — caller-supplied ``name -> callable`` counters (plan picks,
    loaded libraries, live device bytes, config counts, live checkpoint
    dirs).  These are the sharp end: a counter that grows by even ONE after
    warmup is a leak long before RSS shows it.

Trend semantics:

  * the first ``warmup_frac`` of samples is discarded (kernel builds,
    allocator growth, tracemalloc ramp all happen there);
  * a least-squares line is fit over the post-warmup samples;
  * the *projected growth over the whole run* (slope x total steps) must
    stay within an absolute byte tolerance for memory series and within a
    fraction of the median for latency;
  * gauges must be exactly flat post-warmup (tolerance 0 by default).

``SoakResult.write_csv`` emits the sample table (one row per sample point).
"""
from __future__ import annotations

import dataclasses
import os
import time
import tracemalloc
from typing import Callable

import numpy as np

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int:
    """Resident set size of this process, in bytes.

    Reads ``/proc/self/statm`` (second field, pages) on Linux; falls back to
    psutil, then to 0 (trend asserts then only cover tracemalloc/gauges).
    """
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import psutil

        return int(psutil.Process().memory_info().rss)
    except Exception:  # noqa: BLE001 — psutil missing or restricted
        return 0


@dataclasses.dataclass(frozen=True)
class TrendFit:
    """Least-squares line over the post-warmup samples of one series."""

    slope_per_step: float   # fitted units per workload step
    intercept: float
    n_samples: int
    span_steps: int         # steps covered by the post-warmup window

    @property
    def projected_growth(self) -> float:
        """Growth the fitted line predicts over the post-warmup window —
        the quantity the tolerances bound (slope alone is scale-free)."""
        return self.slope_per_step * self.span_steps


class TrendViolation(AssertionError):
    """A soak series grew beyond its documented tolerance."""


@dataclasses.dataclass
class SoakResult:
    """Samples + trend fits of one soak run."""

    name: str
    total_steps: int
    steps: np.ndarray                 # [S] sample step indices (1-based)
    rss: np.ndarray                   # [S] bytes
    traced: np.ndarray                # [S] tracemalloc current bytes
    latency: np.ndarray               # [S] mean seconds/step in the window
    gauges: dict[str, np.ndarray]     # name -> [S]
    warmup_frac: float = 0.2

    # ------------------------------------------------------------ trends ---
    def _post_warmup(self) -> slice:
        k = int(len(self.steps) * self.warmup_frac)
        # always leave >= 2 samples so a line is fittable
        return slice(min(k, max(len(self.steps) - 2, 0)), None)

    def fit(self, series: np.ndarray) -> TrendFit:
        sl = self._post_warmup()
        xs = self.steps[sl].astype(np.float64)
        ys = np.asarray(series, np.float64)[sl]
        if len(xs) < 2:
            return TrendFit(0.0, float(ys[-1]) if len(ys) else 0.0,
                            len(xs), 0)
        slope, intercept = np.polyfit(xs, ys, 1)
        return TrendFit(float(slope), float(intercept), len(xs),
                        int(xs[-1] - xs[0]))

    def rss_trend(self) -> TrendFit:
        return self.fit(self.rss)

    def traced_trend(self) -> TrendFit:
        return self.fit(self.traced)

    def latency_trend(self) -> TrendFit:
        return self.fit(self.latency)

    def gauge_growth(self, name: str) -> float:
        """Max - min of a gauge over the post-warmup window (0 == flat)."""
        sl = self._post_warmup()
        ys = self.gauges[name][sl]
        return float(ys.max() - ys.min()) if len(ys) else 0.0

    # ----------------------------------------------------------- asserts ---
    def assert_flat(self, *, rss_tol_bytes: float = 32 * 2**20,
                    traced_tol_bytes: float = 4 * 2**20,
                    latency_tol_frac: float = 0.5,
                    latency_floor_s: float = 1e-3,
                    gauge_tol: float = 0.0) -> None:
        """Raise :class:`TrendViolation` unless every trend is flat.

        Tolerances bound the *projected growth over the post-warmup window*:

          * ``rss_tol_bytes`` (default 32 MiB): RSS is allocator-noisy, so
            the bound is deliberately coarse — the gauges catch cache leaks
            far earlier;
          * ``traced_tol_bytes`` (default 4 MiB): Python-heap growth;
          * ``latency_tol_frac`` (default 0.5): projected latency growth as
            a fraction of the median post-warmup step latency, with an
            absolute floor of ``latency_floor_s`` (sub-millisecond steps
            are pure scheduler jitter — relative bounds mean nothing there);
          * ``gauge_tol`` (default 0): cache/entry counters must be exactly
            flat after warmup.
        """
        problems: list[str] = []
        r = self.rss_trend()
        if r.projected_growth > rss_tol_bytes:
            problems.append(
                f"rss grows {r.projected_growth / 2**20:.1f} MiB over "
                f"{r.span_steps} steps (tol {rss_tol_bytes / 2**20:.1f} MiB)")
        t = self.traced_trend()
        if t.projected_growth > traced_tol_bytes:
            problems.append(
                f"traced python heap grows {t.projected_growth / 2**20:.2f} "
                f"MiB over {t.span_steps} steps "
                f"(tol {traced_tol_bytes / 2**20:.2f} MiB)")
        lat = self.latency_trend()
        sl = self._post_warmup()
        med = float(np.median(self.latency[sl])) if len(
            self.latency[sl]) else 0.0
        if med > 0 and lat.projected_growth > max(latency_tol_frac * med,
                                                  latency_floor_s):
            problems.append(
                f"step latency grows {lat.projected_growth * 1e3:.2f} ms "
                f"over {lat.span_steps} steps "
                f"(median {med * 1e3:.2f} ms, tol {latency_tol_frac:.0%})")
        for name in self.gauges:
            g = self.gauge_growth(name)
            if g > gauge_tol:
                problems.append(
                    f"gauge {name!r} grew by {g:g} post-warmup "
                    f"(tol {gauge_tol:g}) — cache leak")
        if problems:
            raise TrendViolation(
                f"soak {self.name!r} ({self.total_steps} steps):\n  "
                + "\n  ".join(problems))

    # --------------------------------------------------------------- io ---
    def write_csv(self, path: str) -> None:
        """One row per sample: step, rss, traced, latency, gauges."""
        names = sorted(self.gauges)
        with open(path, "w") as f:
            f.write("step,rss_bytes,traced_bytes,latency_s"
                    + "".join(f",{n}" for n in names) + "\n")
            for i in range(len(self.steps)):
                f.write(f"{int(self.steps[i])},{int(self.rss[i])},"
                        f"{int(self.traced[i])},{self.latency[i]:.6g}")
                for n in names:
                    f.write(f",{self.gauges[n][i]:g}")
                f.write("\n")

    def summary(self) -> str:
        r, t, lat = self.rss_trend(), self.traced_trend(), self.latency_trend()
        g = {n: self.gauge_growth(n) for n in sorted(self.gauges)}
        return (f"{self.name}: {self.total_steps} steps, "
                f"rss {r.projected_growth / 2**20:+.2f} MiB, "
                f"pyheap {t.projected_growth / 2**20:+.3f} MiB, "
                f"latency {lat.projected_growth * 1e3:+.3f} ms, "
                f"gauge growth {g}")


def run_soak(step_fn: Callable[[int], None], *, steps: int, name: str,
             sample_every: int | None = None,
             gauges: dict[str, Callable[[], float]] | None = None,
             warmup_frac: float = 0.2,
             trace_python_heap: bool = True) -> SoakResult:
    """Drive ``step_fn(i)`` for ``steps`` steps, sampling trends.

    ``sample_every`` defaults to ``max(1, steps // 64)`` (about 64 sample
    points regardless of run length).  ``gauges`` are read at every sample
    point; they should be cheap (len() of a dict, a counter read).

    tracemalloc is started/stopped here unless it is already tracing (so a
    caller's own tracemalloc tracing is left untouched); pass
    ``trace_python_heap=False`` to skip it entirely (it adds per-alloc
    overhead — latency-sensitive hardware runs may want it off).
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    every = sample_every or max(1, steps // 64)
    gauges = gauges or {}
    own_trace = trace_python_heap and not tracemalloc.is_tracing()
    if own_trace:
        tracemalloc.start()
    xs, rss_s, traced_s, lat_s = [], [], [], []
    gauge_s: dict[str, list[float]] = {n: [] for n in gauges}
    try:
        window_t0 = time.perf_counter()
        window_n = 0
        for i in range(1, steps + 1):
            step_fn(i)
            window_n += 1
            if i % every == 0 or i == steps:
                now = time.perf_counter()
                xs.append(i)
                rss_s.append(rss_bytes())
                traced_s.append(tracemalloc.get_traced_memory()[0]
                                if tracemalloc.is_tracing() else 0)
                lat_s.append((now - window_t0) / max(window_n, 1))
                for n, fn in gauges.items():
                    gauge_s[n].append(float(fn()))
                window_t0 = time.perf_counter()
                window_n = 0
    finally:
        if own_trace:
            tracemalloc.stop()
    return SoakResult(
        name=name, total_steps=steps,
        steps=np.asarray(xs, np.int64),
        rss=np.asarray(rss_s, np.float64),
        traced=np.asarray(traced_s, np.float64),
        latency=np.asarray(lat_s, np.float64),
        gauges={n: np.asarray(v, np.float64) for n, v in gauge_s.items()},
        warmup_frac=warmup_frac)
