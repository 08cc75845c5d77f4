"""The seeded generator."""
import numpy as np

from portbench import traffic


def test_arrivals_follow_the_seed_and_offer_the_stated_rate():
    spec = {"phases": [{"rate_per_s": 2000.0, "seconds": 1.0}]}
    due, idx = traffic.arrivals(spec, 10.0, 2**31 + 77, pool=256)
    again, idx2 = traffic.arrivals(spec, 10.0, 2**31 + 77, pool=256)
    other, _ = traffic.arrivals(spec, 10.0, 2**31 + 78, pool=256)
    assert np.array_equal(due, again) and np.array_equal(idx, idx2)
    assert not np.array_equal(due, other)
    assert due.size == other.size == 20_000
    assert np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 10.0
    assert idx.min() >= 0 and idx.max() < 256
    gaps = np.diff(due)
    assert abs(gaps.mean() - 1 / 2000) < 0.02 / 2000
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05      # exponential gaps
    per_second = np.histogram(due, bins=10, range=(0, 10))[0]
    assert per_second.tolist() == [2000] * 10


def test_phases_cycle_for_on_off_bursts():
    spec = {"phases": [{"rate_per_s": 3000.0, "seconds": 0.5},
                       {"rate_per_s": 500.0, "seconds": 1.5}]}
    due, _ = traffic.arrivals(spec, 4.0, 5, pool=8)
    counts = np.histogram(due, bins=[0, 0.5, 2.0, 2.5, 4.0])[0]
    assert counts.tolist() == [1500, 750, 1500, 750]
    assert traffic.offered_rate(spec) == 1125.0


def test_kept_calls_follow_the_seed():
    a = traffic.kept_calls(2**31 + 1, 64, 8)
    assert a == traffic.kept_calls(2**31 + 1, 64, 8) and len(a) == 8
    assert all(0 <= i < 64 for i in a)
    assert traffic.kept_calls(3, 4, 8) == {0, 1, 2, 3}
