"""Unit tests of the port's soak harness (``repro_torch.testing.soak``).

The eight cases of the JAX package's ``tests/test_soak_harness.py`` on the
port's copy — flat workloads pass, each leak class (python heap, gauge,
latency) raises a TrendViolation naming the guilty series, warmup samples
are excluded, the CSV artifact round-trips — plus the two harnesses held
against each other: on the same numpy series every fit and every
``assert_flat`` verdict (defaults and message) is the same.
"""
import csv

import numpy as np
import pytest

from repro.testing import soak as jsoak
from repro_torch.testing import soak


def _result(module=soak, *, steps=1000, rss=None, traced=None, latency=None,
            gauges=None):
    """Hand-built SoakResult over 50 sample points."""
    xs = np.linspace(20, steps, 50).astype(np.int64)
    z = np.zeros(50)
    return module.SoakResult(
        name="synthetic", total_steps=steps, steps=xs,
        rss=np.asarray(rss if rss is not None else z, np.float64),
        traced=np.asarray(traced if traced is not None else z, np.float64),
        latency=np.asarray(latency if latency is not None else z + 1e-3,
                           np.float64),
        gauges={n: np.asarray(v, np.float64)
                for n, v in (gauges or {}).items()})


def test_flat_run_passes():
    rng = np.random.default_rng(0)
    _result(rss=1e8 + rng.normal(0, 1e4, 50),
            traced=5e6 + rng.normal(0, 1e3, 50),
            latency=1e-3 + rng.normal(0, 1e-6, 50),
            gauges={"cache": np.full(50, 4.0)}).assert_flat()


def test_python_heap_leak_raises():
    leak = 5e6 + np.linspace(0, 64e6, 50)          # ~64 MiB over the run
    with pytest.raises(soak.TrendViolation, match="traced python heap"):
        _result(traced=leak).assert_flat()


def test_gauge_leak_raises_even_by_one_entry():
    g = np.full(50, 4.0)
    g[-5:] = 5.0                                   # one late extra entry
    with pytest.raises(soak.TrendViolation, match="cache leak"):
        _result(gauges={"exec_live_bytes": g}).assert_flat()


def test_latency_creep_raises():
    lat = 1e-3 * (1 + np.linspace(0, 2.0, 50))     # 3x slowdown
    with pytest.raises(soak.TrendViolation, match="step latency"):
        _result(latency=lat).assert_flat()


def test_warmup_window_is_excluded():
    # big ramp confined to the first 20% of samples, flat afterwards: must
    # pass, because kernel builds and allocator growth look exactly like this
    traced = np.full(50, 30e6)
    traced[:10] = np.linspace(1e6, 30e6, 10)
    _result(traced=traced).assert_flat()


def test_run_soak_samples_and_detects_real_leak():
    sink = []

    def leaky(i):
        sink.append(bytearray(64 * 1024))          # 64 KiB per step

    res = soak.run_soak(leaky, steps=300, name="leaky", sample_every=10)
    assert len(res.steps) == 30
    with pytest.raises(soak.TrendViolation):
        res.assert_flat(traced_tol_bytes=1e6)
    # and a no-op workload is flat under the same tolerances
    soak.run_soak(lambda i: None, steps=300, name="idle",
                  sample_every=10).assert_flat(traced_tol_bytes=1e6)


def test_write_csv_roundtrip(tmp_path):
    res = soak.run_soak(lambda i: None, steps=64, name="csv", sample_every=8,
                        gauges={"g": lambda: 3.0})
    path = tmp_path / "trend.csv"
    res.write_csv(str(path))
    rows = list(csv.DictReader(path.open()))
    assert len(rows) == len(res.steps)
    assert set(rows[0]) == {"step", "rss_bytes", "traced_bytes", "latency_s", "g"}
    assert all(float(r["g"]) == 3.0 for r in rows)
    assert int(rows[-1]["step"]) == 64


def test_rss_bytes_reads_something():
    # on linux this is /proc/self/statm; anywhere else psutil or 0 — the
    # contract is "non-negative int, stable within a few pages across calls"
    a, b = soak.rss_bytes(), soak.rss_bytes()
    assert a >= 0 and b >= 0
    if a:
        assert abs(a - b) < 64 * 2**20


def _series():
    rng = np.random.default_rng(7)
    g = np.full(50, 4.0)
    g[-5:] = 5.0
    ramp = np.full(50, 30e6)
    ramp[:10] = np.linspace(1e6, 30e6, 10)
    return {
        "flat": dict(rss=1e8 + rng.normal(0, 1e4, 50), traced=5e6 + rng.normal(0, 1e3, 50),
                     latency=1e-3 + rng.normal(0, 1e-6, 50), gauges={"c": np.full(50, 4.0)}),
        "heap_leak": dict(traced=5e6 + np.linspace(0, 64e6, 50)),
        "rss_leak": dict(rss=1e8 + np.linspace(0, 45 * 2**20, 50)),
        "gauge_step": dict(gauges={"c": g}),
        "latency_creep": dict(latency=1e-3 * (1 + np.linspace(0, 2.0, 50))),
        "sub_ms_jitter": dict(latency=1e-4 * (1 + np.linspace(0, 4.0, 50))),
        "warmup_ramp": dict(traced=ramp),
    }


@pytest.mark.parametrize("kind", sorted(_series()))
def test_fits_and_verdicts_equal_the_jax_harness(kind):
    kw = _series()[kind]
    mine, ref = _result(soak, **kw), _result(jsoak, **kw)
    for series in ("rss", "traced", "latency"):
        a, b = mine.fit(getattr(mine, series)), ref.fit(getattr(ref, series))
        assert (a.slope_per_step, a.intercept, a.n_samples, a.span_steps,
                a.projected_growth) == (b.slope_per_step, b.intercept, b.n_samples,
                                        b.span_steps, b.projected_growth)
    assert {n: mine.gauge_growth(n) for n in mine.gauges} == {
        n: ref.gauge_growth(n) for n in ref.gauges}
    assert mine.summary() == ref.summary()
    verdicts = []
    for r, exc in ((mine, soak.TrendViolation), (ref, jsoak.TrendViolation)):
        try:
            r.assert_flat()
            verdicts.append(None)
        except exc as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] is None) == (kind in ("flat", "sub_ms_jitter", "warmup_ramp"))
