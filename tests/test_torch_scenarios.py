"""The port's four soak scenarios on the CPU, short.

Each scenario of ``repro_torch.testing.scenarios`` runs through
``run_soak`` for under 100 steps with the acceptance asserts of the JAX
package's ``tests/test_soak.py`` scaled to the steps run: every gauge
exactly flat after warmup, the Python heap within ``assert_flat``'s
default 4 MiB, and the progress counters (decode steps, execute calls,
checkpoint cycles, and ``cnn_server``'s full reconciliation of injected
against observed faults).  Latency and RSS trends are the card's: on a
short CPU run they are scheduler and allocator noise.  The scenarios run
``device="cpu"``, where the kernels' plain versions run and no live device
bytes are gauged.
"""
import pytest
import torch

from repro_torch.deploy import executor
from repro_torch.testing import scenarios as sc
from repro_torch.testing.soak import run_soak


def _assert_flat_gauges(result):
    assert result.gauges, "a scenario without gauges asserts nothing"
    growth = {n: result.gauge_growth(n) for n in result.gauges}
    assert all(g == 0 for g in growth.values()), growth
    assert result.traced_trend().projected_growth <= 4 * 2**20, result.summary()


def test_executor_gauges_name_what_can_grow():
    stats = executor.cache_stats()
    assert set(stats) == {"plan_picks", "kernel_libs", "launches"}
    assert set(executor.cache_gauges("cpu")) == {"exec_plan_picks", "exec_kernel_libs"}
    # a card adds live device bytes (the gauge is built, not read, here)
    assert set(executor.cache_gauges(torch.device("cuda", 0))) == {
        "exec_plan_picks", "exec_kernel_libs", "exec_live_bytes"}


def test_scenarios_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the scenarios run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        sc.tiny_cnn_program()
    with pytest.raises(RuntimeError, match="cuda"):
        sc.checkpoint_scenario(str(tmp_path))


def test_server_scenario_mixed_traffic():
    scen = sc.server_scenario(device="cpu")
    result = run_soak(scen.step, steps=100, name=scen.name, gauges=scen.gauges)
    stats = scen.progress()
    # two level-count groups per round: ~2 decodes per step, as 1100 steps
    # give >= 2000 in the JAX soak
    assert stats["decode_steps"] >= 180, stats
    assert stats["bulk_prefills"] > 9 and stats["prefill_unique_lens"] == 4, stats
    assert set(scen.gauges) >= {"decode_fns", "prefill_fns", "prefill_lens"}
    _assert_flat_gauges(result)


def test_executor_scenario_rotating_schedules():
    scen = sc.executor_scenario(device="cpu")
    result = run_soak(scen.step, steps=64, name=scen.name, gauges=scen.gauges)
    stats = scen.progress()
    assert stats["execute_calls"] == 64, stats
    assert set(stats) >= {"plan_picks", "kernel_libs", "launches"}
    _assert_flat_gauges(result)


def test_cnn_server_scenario_faulty_traffic():
    """Three 30-step clean/storm/clean cycles (the JAX soak runs six of 54):
    every completed answer torch.equal to the clean execute, every injected
    fault reconciled, every bit flip healed, back to rung 0 at the end."""
    scen = sc.cnn_server_scenario(device="cpu", cycle=30)
    result = run_soak(scen.step, steps=90, name=scen.name, gauges=scen.gauges)
    p = scen.progress()
    stats = p["stats"]
    assert p["verified"] > 28 and p["mismatches"] == 0, p
    inj = p["injected"]
    assert stats["exec_exceptions"] == inj["error"], (stats, inj)
    assert stats["nonfinite_detected"] == inj["nan"] + inj["inf"], (stats, inj)
    assert inj["error"] > 0 and inj["nan"] > 0 and inj["latency"] > 0, inj
    assert stats["retries"] > 0, stats
    assert stats["exec_failed_batches"] == 0 and p["failed"] == 0, (stats, p)
    hist = stats["rung_hist"]
    assert hist.get(0, 0) > 0 and sum(v for k, v in hist.items() if k > 0) > 0, hist
    assert stats["rung"] == 0 and not stats["shedding"], stats
    assert stats["shed"]["deadline_expired"] > 0 and stats["shed"]["slo_shed"] > 0, stats
    assert stats["queue_depth"] <= 2 * 4, stats
    assert inj["bitflip_mem"] == inj["bitflip_disk"] == 3, inj
    assert stats["reloads"] == stats["selftest_failures"] == inj["bitflip_mem"], (stats, inj)
    assert stats["quarantined_steps"] == p["ckpt_quarantined"] == inj["bitflip_disk"], (
        stats, p, inj)
    assert stats["selftest_runs"] > stats["selftest_failures"], stats
    svc = scen.subject
    assert 1 < len(svc._schedules_seen) <= len(svc.controller.ladder)
    assert scen.gauges["svc_schedules_seen"]() == len(svc._schedules_seen)
    assert svc.quarantined_program.device.type == "cpu"
    _assert_flat_gauges(result)


def test_checkpoint_scenario_save_load_cycle(tmp_path):
    scen = sc.checkpoint_scenario(str(tmp_path / "ckpt"), device="cpu")
    result = run_soak(scen.step, steps=30, name=scen.name, gauges=scen.gauges)
    stats = scen.progress()
    assert stats["cycles"] == 30, stats
    assert stats["ckpt_dirs"] <= 2, stats       # keep=2 GC held
    _assert_flat_gauges(result)


def test_faulty_serving_leaves_no_tensor_in_a_reference_cycle():
    """A storm's failed attempts, hot reload and checkpoint walk free their
    tensors when the step returns: nothing they touched waits in a
    reference cycle for the cycle collector (on a card that is device
    memory, which ``exec_live_bytes`` reads between steps)."""
    import gc
    import types

    scen = sc.cnn_server_scenario(device="cpu")
    gc.collect()
    gc.disable()
    try:
        for i in range(1, 28):      # a clean phase and the first storm, flips included
            scen.step(i)
        assert scen.progress()["stats"]["reloads"] == 1
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [type(o).__name__ for o in gc.garbage
                if isinstance(o, (torch.Tensor, types.FrameType, BaseException))]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
