"""A whole run on the CPU at a toy size, with the timed path broken under
``port.execute``: each fault a cell can have must make ``correct`` false,
and the sound path must keep it true.  (One card: no exchange between
cards to leave out.)"""
import time

import pytest
import torch

from portbench import check, harness
from portbench.tests import toy
from repro_torch.deploy import executor

CPU = torch.device("cpu")
CELLS = [("cnn_a", "offline_b1024"), ("mobilenet_v1_224", "offline_b128_m1"),
         ("mobilenet_v1_224", "serve_b16_poisson")]


def altered(orig):
    """One answer of every call altered where it is produced."""
    def run(program, x, m):
        y = orig(program, x, m).clone()
        y[0, 0] += 1e-2 * y[0].abs().max()
        return y
    return run


def stale(orig):
    """Every call after the first returns the state it left: the previous answers."""
    prev = []

    def run(program, x, m):
        if not prev:
            prev.append(orig(program, x, m))
        return prev[0]
    return run


def half(orig):
    """Half of the batch left out, the mean of the rest in its place."""
    def run(program, x, m):
        y = orig(program, x[: x.shape[0] // 2 or 1], m)
        rest = y.mean(0, keepdim=True).expand(x.shape[0] - y.shape[0], -1)
        return torch.cat([y, rest])
    return run


def _run(config, traffic_name, seed=2**31 + 3):
    limits = check.limits(f"{config}.{traffic_name}")
    cell = toy.cell(config, traffic_name, limits)
    return harness.run_cell(cell, seed, 0.4, False, CPU, time.perf_counter())["result"]


@pytest.mark.parametrize("config,traffic_name", CELLS)
def test_sound_run_is_correct(config, traffic_name):
    result = _run(config, traffic_name)
    assert result["correct"] is True
    assert list(result["check"])[0] == "rel_err"
    assert result["attempted"] > 0


@pytest.mark.parametrize("fault", [altered, stale, half])
@pytest.mark.parametrize("config,traffic_name", CELLS)
def test_planted_fault_makes_the_run_incorrect(monkeypatch, config, traffic_name, fault):
    monkeypatch.setattr(executor, "execute", fault(executor.execute))
    result = _run(config, traffic_name)
    assert result["correct"] is False
    assert result["check"]["rel_err"]["value"] > result["check"]["rel_err"]["limit"]


@pytest.mark.parametrize("config,traffic_name", CELLS)
def test_traced_run_reports_what_the_cpu_can_read(config, traffic_name):
    """On the CPU the trace holds no device span: the device readers give
    nothing and the serve split, read from the host clock there, is read."""
    from portbench import manifest
    cell = toy.cell(config, traffic_name, check.limits(f"{config}.{traffic_name}"))
    cell.per_layer = manifest.cell_metrics(manifest.load(), f"{config}.{traffic_name}")[1]
    result = harness.run_cell(cell, 2**31 + 9, 0.6, True, CPU, time.perf_counter())["result"]
    assert result["correct"] is True
    assert "busy_s" not in result["device"] and "breakdown" not in result
    want = {"serve.assemble_h2d_ms", "serve.screen_d2h_ms", "executor.execute_ms.serve"} \
        if "serve" in traffic_name else set()
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
