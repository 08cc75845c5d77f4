"""Soak scenarios for the port's long-lived serving surfaces.

Port of ``repro/testing/scenarios.py``.  Each scenario function returns
a :class:`Scenario` — a step closure plus the gauges that must stay flat —
consumed by ``repro_torch.testing.soak.run_soak`` from the CPU tests
(``tests/test_torch_scenarios.py``), ``tools/torch_soak.py`` and phase 9
of ``chip_smoke.py``.  Each takes ``device`` (default ``"cuda"``, raising
without a card); the JAX package's ``interpret=True`` has no counterpart,
since the port routes each kernel call by the tensor's device.

  * ``server_scenario`` — ``launch.serve.Server`` under continuous mixed
    traffic: rotating prompt lengths (the bucketed-prefill map) and
    rotating per-request ``m_active`` (the per-level-count configs).  Every
    soak step is one batched decode round; freed slots are re-admitted at
    once so the server never idles.
  * ``executor_scenario`` — ``deploy.execute`` over compiled CNN-A and
    MobileNet programs with a fixed rotation of §IV-D schedules (global
    ints + per-layer lists).  ``execute`` picks no plan and builds each
    kernel library once, so those gauges freeze after the first lap.
  * ``checkpoint_scenario`` — the ``save_program``/``load_program`` cycle
    through ``checkpoint/manager.py``: repeated checkpointing must neither
    grow the heap nor the on-disk step count (the manager's ``keep`` GC).
  * ``cnn_server_scenario`` — ``serve_cnn.CNNService`` under *faulty*
    cyclic traffic: a seeded ``testing.faults`` injector alternates clean /
    fault-storm / clean phases (latency spikes, raised exceptions, NaN
    outputs, plus one disk + one in-memory bit flip per storm) on a
    virtual clock, so the SLO controller walks down the §IV-D ladder under
    pressure and back to full-M after, and the golden watchdog hot-reloads
    through the last-known-good checkpoint walk — while every completed
    answer is checked ``torch.equal`` against the *unfaulted*
    ``deploy.execute`` on the same padded batch, and every injected fault
    reconciles against the service's disposition counters.

On a card every scenario also gauges live device bytes
(``deploy.executor.cache_gauges``), read between steps: a device tensor
left referenced (a replaced program, a reference cycle awaiting the cycle
collector) shows as growth.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device

_DEFAULT = object()


@dataclasses.dataclass
class Scenario:
    """A soak workload: ``step(i)`` plus flat-by-contract gauges."""

    name: str
    step: Callable[[int], None]
    gauges: dict[str, Callable[[], float]]
    # scenario-specific counters for acceptance asserts (e.g. decode steps)
    progress: Callable[[], dict]
    # the surface under soak where there is one (the Server, the
    # CNNService), for callers that inspect what it served
    subject: object = None


def _sync(dev: torch.device) -> None:
    """Block until the card finished the step (JAX's block_until_ready)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# launch/serve.py under mixed traffic
# ---------------------------------------------------------------------------

def server_scenario(*, family: str = "gemma_2b", max_batch: int = 4,
                    max_len: int = 64, seed: int = 0, device="cuda") -> Scenario:
    """Continuous mixed per-request ``m_active`` + bucketed-prefill traffic
    on ``reduced(family)`` in fp32, as the JAX scenario makes it.

    The admission pattern cycles prompt lengths {3, 5, 7, 9} (pow2 buckets
    2/4/8) x ``m_active`` {None, 1} so every soak step exercises grouped
    decode with two level-count groups and the prefill-length bucket map.
    """
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.deploy import executor
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import api

    dev = resolve_device(device)
    cfg = reduced(get_config(family)).replace(dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
    srv = Server(cfg, params, max_batch=max_batch, max_len=max_len)
    pattern = [(3, None), (5, 1), (7, None), (9, 1)]
    counter = [0]

    def admit_to_full():
        while any(s is None for s in srv.slots):
            n, m = pattern[counter[0] % len(pattern)]
            counter[0] += 1
            ok = srv.admit(Request(
                prompt=np.arange(1, n + 1, dtype=np.int32),
                max_new_tokens=4, m_active=m))
            if not ok:
                break

    def step(i: int) -> None:
        admit_to_full()
        srv.step()
        _sync(dev)

    return Scenario(
        name=f"server_{family}",
        step=step,
        gauges={**srv.cache_gauges(), **executor.cache_gauges(dev)},
        progress=lambda: dict(srv.stats),
        subject=srv)


# ---------------------------------------------------------------------------
# deploy.execute over compiled programs
# ---------------------------------------------------------------------------

def _rotating_schedules(program) -> list:
    """A fixed schedule rotation for one program: all levels, the global
    §IV-D throughput switch, and two per-layer schedules (front-half vs
    back-half reduced) — four distinct resolved schedules, re-visited
    forever."""
    n = len(program)
    half = n // 2
    front = tuple([1] * half + [2] * (n - half))
    back = tuple([2] * half + [1] * (n - half))
    scheds = [None, 1, front, back]
    # dedupe resolved forms (tiny programs may collapse some)
    seen, out = set(), []
    for s in scheds:
        r = program.resolve_schedule(s)
        if r not in seen:
            seen.add(r)
            out.append(s)
    return out


def executor_scenario(*, archs=("cnn_a", "mobilenet"), batch: int = 2,
                      mobilenet_kw: dict = _DEFAULT, seed: int = 0,
                      device="cuda") -> Scenario:
    """Rotate compiled programs x §IV-D schedules through ``deploy.execute``.

    ``archs`` defaults to CNN-A plus the MobileNet (CNN-B) topology, the
    latter at width 0.25, 32², 10 classes unless ``mobilenet_kw`` says
    otherwise (``tools/torch_soak.py --mobilenet-b2`` and ``chip_smoke.py``
    pass width 1.0, 1000 classes, 224²).
    """
    from repro_torch import deploy
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.deploy import executor
    from repro_torch.models import cnn

    dev = resolve_device(device)
    if mobilenet_kw is _DEFAULT:
        mobilenet_kw = {"width_mult": 0.25, "n_classes": 10, "resolution": 32}
    qc = QuantConfig(mode="binary", M=2, K_iters=2)
    gen = torch.Generator().manual_seed(seed)
    work = []
    for arch in archs:
        if arch == "cnn_a":
            params = cnn.init_cnn_a(gen, device=dev)
            shape = (batch, 48, 48, 3)
            packed = cnn.binarize_cnn_a(params, qc)
        else:
            res = mobilenet_kw.get("resolution", 32)
            init_kw = {k: v for k, v in mobilenet_kw.items() if k != "resolution"}
            params = cnn.init_mobilenet(gen, **init_kw, device=dev)
            shape = (batch, res, res, 3)
            packed = cnn.binarize_mobilenet(params, qc)
        prog = deploy.compile(packed, arch, qc, shape, device=dev, golden=False)
        x = torch.randn(shape, generator=gen).to(dev)
        for sched in _rotating_schedules(prog):
            work.append((prog, x, sched))
    calls = [0]

    def step(i: int) -> None:
        prog, x, sched = work[(i - 1) % len(work)]
        deploy.execute(prog, x, sched)
        _sync(dev)
        calls[0] += 1

    return Scenario(
        name="executor_" + "_".join(archs),
        step=step,
        gauges=executor.cache_gauges(dev),
        progress=lambda: {"execute_calls": calls[0], **executor.cache_stats(dev)})


# ---------------------------------------------------------------------------
# serve_cnn.CNNService under faulty traffic
# ---------------------------------------------------------------------------

def tiny_cnn_program(*, batch: int = 4, m: int = 2, seed: int = 0, device="cuda"):
    """A small custom-topology program for serving tests/soaks: 3x3 SAME
    conv (D=8, AMU pool 2) on 8x8x3 images into a flatten->10 linear head,
    with its golden record.  Cheap enough for thousands of calls, deep
    enough that the degradation ladder has distinct front-half/global
    rungs."""
    from repro_torch import deploy
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.models.cnn import LayerSpec, spec_binarize

    dev = resolve_device(device)
    specs = (
        LayerSpec("c0", "conv", kh=3, kw=3, padding="SAME", pool=2),
        LayerSpec("fc", "linear", pre="flatten", relu=False),
    )
    gen = torch.Generator().manual_seed(seed)
    params = {
        "c0": {"w": (torch.randn((3, 3, 3, 8), generator=gen) / 9.0).to(dev)},
        "fc": {"w": (torch.randn((4 * 4 * 8, 10), generator=gen) * 0.1).to(dev)},
    }
    qc = QuantConfig(mode="binary", M=m, K_iters=4)
    packed = spec_binarize(specs, params, qc)
    return deploy.compile(packed, specs, qc, (batch, 8, 8, 3), device=dev)


def cnn_server_scenario(*, seed: int = 0, cycle: int = 54,
                        batch_size: int = 4, verify_every: int = 3,
                        directory: str | None = None,
                        selftest_every: int = 3, device="cuda") -> Scenario:
    """Faulty cyclic traffic against :class:`repro_torch.serve_cnn.CNNService`.

    Each ``cycle`` (default 54 steps — phases long enough that the full
    recover-to-rung-0 walk lands inside the cycle's own clean tail) is
    three equal phases on a shared
    :class:`~repro_torch.testing.faults.ManualClock` (1 ms virtual
    frame/step):

      1. **clean** — zero fault rates; request latency ~0 vs the 10 ms
         target, so the controller sits (or recovers to) rung 0 (full-M);
      2. **storm** — every call eats a 50 ms virtual latency spike with
         probability 0.9, plus seeded executor exceptions and NaN outputs.
         p99 blows through the target and the controller walks down the
         ladder (the first storm visits every rung, inside the soak warmup
         window, so the distinct-schedule gauge is flat after);
      3. **clean again** — pressure clears and the controller climbs back.

    On top of the rate faults, every storm carries one **bit-flip pair**:
    the latest on-disk checkpoint step takes a seeded flip in a packed leaf
    at the storm's first step, and the *live program* takes an in-memory
    packed-buffer flip six steps later.  The golden watchdog
    (``selftest_every``) catches the memory flip, quarantines the program
    and hot-reloads through ``load_latest_good``, which hits the
    disk-flipped step first, quarantines it (``ChecksumMismatch``) and
    falls back to the previous good step.  One fresh step is saved at the
    start of every cycle, so the walk always has a fallback.

    Traffic: ``batch_size`` requests per step, plus a request with a
    too-tight virtual deadline every 6th step (shed at *dispatch*) and an
    already-expired one every 13th (shed at *admit*).  Every
    ``verify_every``-th step the completed logits are compared
    ``torch.equal`` against the clean ``deploy.execute`` on the service's
    own padded batch at the served schedule; ``progress()`` exposes the
    verified/mismatch counters, the service's disposition stats and the
    injector ledger so a caller can reconcile injected == observed.
    """
    import tempfile

    from repro_torch import deploy
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.deploy import executor
    from repro_torch.serve_cnn import CNNService, SLOConfig
    from repro_torch.testing.faults import FaultInjector, FaultPlan, ManualClock

    assert cycle % 3 == 0, cycle
    program = tiny_cnn_program(batch=batch_size, seed=seed, device=device)
    clock = ManualClock()
    inj = FaultInjector(FaultPlan(seed=seed), sleep=clock.sleep)
    clean = FaultPlan(seed=seed)
    storm = FaultPlan(latency_rate=0.9, latency_s=0.05, error_rate=0.15,
                      nan_rate=0.10, seed=seed)
    if directory is None:
        directory = tempfile.mkdtemp(prefix="soak_ckpt_")
    mgr = CheckpointManager(directory, keep=4)
    next_step = [0]

    def save_step():
        next_step[0] += 1
        deploy.save_program(mgr, next_step[0], program)

    save_step()
    save_step()     # two good steps before any corruption
    svc = CNNService(
        program,
        slo=SLOConfig(target_ms=10.0, window=16, min_samples=8,
                      recover_at=0.6, recover_after=2),
        batch_size=batch_size, max_queue=4 * batch_size,
        max_retries=4, backoff_s=0.001,
        clock=clock, sleep=clock.sleep,
        execute_fn=inj.wrap_execute(executor.execute),
        selftest_every=selftest_every, checkpoint_manager=mgr,
        restore_like=dataclasses.replace(program, golden=None))
    rng = np.random.default_rng(seed + 1)
    counters = {"verified": 0, "mismatches": 0, "submitted": 0,
                "done": 0, "failed": 0}

    def step(i: int) -> None:
        offset = (i - 1) % cycle
        phase = offset // (cycle // 3)
        inj.plan = storm if phase == 1 else clean
        if offset == 0:
            save_step()                       # fresh fallback every cycle
        if offset == cycle // 3:              # storm opens: rot the newest
            inj.flip_bit_on_disk(mgr._step_dir(mgr.latest_step()))
        if offset == cycle // 3 + 6:          # mid-storm: corrupt the live
            svc.program = inj.flip_bit_in_program(svc.program)
        clock.advance(0.001)
        for _ in range(batch_size):
            img = rng.standard_normal(program.input_shape[1:],
                                      dtype=np.float32)
            svc.submit(img)
            counters["submitted"] += 1
        if i % 6 == 0:      # expires while queued -> shed at dispatch
            svc.submit(np.zeros(program.input_shape[1:], np.float32),
                       deadline_s=clock() + 5e-4)
            counters["submitted"] += 1
        if i % 13 == 0:     # dead on arrival -> shed at admit
            svc.submit(np.zeros(program.input_shape[1:], np.float32),
                       deadline_s=clock() - 1.0)
            counters["submitted"] += 1
        finished = svc.step()
        done = [r for r in finished if r.status == "done"]
        counters["done"] += len(done)
        counters["failed"] += sum(r.status == "failed" for r in finished)
        if done and i % verify_every == 0:
            # clean reference on the exact padded batch + schedule served
            ref = deploy.execute(svc.program, svc.last_batch, svc.last_schedule).cpu()
            for r in done:
                counters["verified"] += 1
                if not torch.equal(r.logits, ref[r.batch_index]):
                    counters["mismatches"] += 1

    def progress() -> dict:
        return {**counters, "stats": svc.stats,
                "injected": dict(inj.counts),
                "ckpt_live_steps": len(mgr.all_steps()),
                "ckpt_quarantined": len(mgr.quarantine_dirs())}

    return Scenario(
        name="cnn_server_faulty",
        step=step,
        gauges=svc.cache_gauges(),
        progress=progress,
        subject=svc)


# ---------------------------------------------------------------------------
# checkpoint save/load cycle
# ---------------------------------------------------------------------------

def checkpoint_scenario(directory: str, *, keep: int = 2, seed: int = 0,
                        device="cuda") -> Scenario:
    """Repeated ``save_program`` -> ``load_program`` -> execute cycles of
    CNN-A at batch 1.

    Gauges: live checkpoint step-dirs on disk (the manager's ``keep`` GC
    contract) and the executor's — plus ``run_soak``'s heap/RSS sampling
    catches manifest or array-copy leaks in the save path.
    """
    from repro_torch import deploy
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.deploy import executor
    from repro_torch.models import cnn

    dev = resolve_device(device)
    qc = QuantConfig(mode="binary", M=2, K_iters=2)
    params = cnn.init_cnn_a(torch.Generator().manual_seed(seed), device=dev)
    prog = deploy.compile(cnn.binarize_cnn_a(params, qc), "cnn_a", qc,
                          (1, 48, 48, 3), device=dev)
    like = deploy.abstract_program("cnn_a", qc, (1, 48, 48, 3), device=dev)
    mgr = CheckpointManager(directory, keep=keep)
    x = torch.ones((1, 48, 48, 3), device=dev)
    cycles = [0]

    def live_dirs() -> int:
        return sum(1 for d in os.listdir(directory) if d.startswith("step_"))

    def step(i: int) -> None:
        deploy.save_program(mgr, i, prog)
        back = deploy.load_program(mgr, i, like)
        deploy.execute(back, x)
        _sync(dev)
        cycles[0] += 1

    return Scenario(
        name="checkpoint_cycle",
        step=step,
        gauges={"ckpt_dirs": live_dirs, **executor.cache_gauges(dev)},
        progress=lambda: {"cycles": cycles[0], "ckpt_dirs": live_dirs()})


SCENARIOS = {
    "server": server_scenario,
    "executor": executor_scenario,
    "checkpoint": checkpoint_scenario,
    "cnn_server": cnn_server_scenario,
}
