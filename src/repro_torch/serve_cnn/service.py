"""CNNService: continuous-batching image inference over a BinArrayProgram.

Port of ``repro/serve_cnn/service.py``: a bounded request queue with
per-request deadlines feeding fixed-size batches into ``deploy.execute``,
governed by the §IV-D degradation ladder (:mod:`repro_torch.serve_cnn.slo`).
The contract: every fault is **retried, shed, or degraded — never a silent
wrong answer, never a stuck queue.**

  * **transient executor failures** (raised exceptions, a CUDA kernel's
    launch error included, and NaN/Inf outputs caught by the finite screen)
    — bounded retry with exponential backoff; a batch that exhausts its
    retries fails loudly (``status="failed"`` with the error attached) and
    the queue keeps draining.  Nothing is rerouted to the plain versions.
  * **latency pressure** — the SLO controller walks the ladder down, and
    back up when the windowed p99 clears.
  * **overload** — admission sheds with a named reason (``queue_full``,
    ``deadline_expired``, ``slo_shed``); requests that expire while queued
    are shed at dispatch.
  * **in-memory program corruption** — a watchdog (``selftest_every``)
    replays the golden probe (``deploy.self_test``) on the active rung every
    N batches and on every rung change; a mismatch quarantines the live
    program and hot-reloads the last good checkpoint
    (``deploy.load_latest_good``), or raises when none is wired.

Each batch is staged on the host, zero-padded to ``batch_size``, copied to
the program's device, executed, screened with one ``isfinite`` reduction
and copied back once; every answer is bit-exact against ``deploy.execute``
on the same padded batch at the same schedule (``last_batch`` /
``last_schedule`` expose the pair).  ``clock``/``sleep`` are injectable
(tests pass ``testing.faults.ManualClock``), and the default path looks up
``repro_torch.deploy.executor.execute`` at call time, so the fault
injector's patch (``testing.faults.inject_faults``) reaches it while
``repro_torch.deploy.execute`` stays the clean reference.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import _flatten_with_paths, _unflatten
from repro_torch.deploy.program import BinArrayProgram
from repro_torch.serve_cnn.slo import SLOConfig, SLOController, default_ladder

SHED_REASONS = ("queue_full", "deadline_expired", "slo_shed")


def _on_host(program: BinArrayProgram) -> BinArrayProgram:
    """``program`` with its tensors copied to the host: a quarantined
    program is kept for inspection without holding device memory, so a
    storm of hot reloads does not step live device bytes up."""
    flat, treedef = _flatten_with_paths(program)
    return _unflatten(treedef, [t.cpu() for t in flat.values()])


class NonFiniteOutput(RuntimeError):
    """The executor returned NaN/Inf logits — a wrong answer that must never
    reach a client.  Handled like a transient executor fault (retried, then
    failed loudly)."""


@dataclasses.dataclass
class ImageRequest:
    """One inference request and its lifecycle record.

    ``deadline_s`` is an absolute time on the service clock (None = no
    deadline).  ``status`` walks pending -> queued -> done | shed | failed;
    shed requests carry ``shed_reason``, failed ones ``error``.  Completed
    requests carry their ``logits`` (a CPU tensor), the ``m_schedule`` and
    ``rung`` they were computed at, their ``batch_index`` in the padded
    batch, and ``latency_s``.
    """

    image: np.ndarray
    deadline_s: float | None = None
    id: int = -1
    status: str = "pending"
    shed_reason: str | None = None
    error: str | None = None
    logits: torch.Tensor | None = None
    m_schedule: tuple[int, ...] | None = None
    rung: int | None = None
    batch_index: int | None = None
    submit_t: float = 0.0
    latency_s: float | None = None


class CNNService:
    """SLO-governed continuous-batching inference over one compiled program.

    Parameters
    ----------
    program:      the compiled :class:`BinArrayProgram`; batches run on its
                  device.
    slo:          :class:`SLOConfig`; ``target_ms=None`` (default) pins the
                  ladder at ``initial_rung`` and never sheds on pressure.
    ladder:       degradation schedules; default :func:`default_ladder`.
    batch_size:   padded device batch.
    max_queue:    admission bound; beyond it requests shed ``queue_full``.
    max_retries:  executor re-attempts per batch before failing loudly.
    backoff_s:    base of the exponential retry backoff.
    clock/sleep:  time sources (injectable for deterministic tests).
    execute_fn:   ``fn(program, x, m_active)``; default late-binds
                  ``repro_torch.deploy.executor.execute`` so fault-injection
                  patches apply.
    selftest_every: run the golden self-test (always the clean execute
                  path) on the active rung every this-many served batches,
                  plus once at startup and on every rung change.  Requires
                  a GoldenRecord.  None (default) disables the watchdog.
    checkpoint_manager / restore_like: recovery source for the watchdog —
                  on a self-test failure the live program is quarantined and
                  ``deploy.load_latest_good(checkpoint_manager,
                  restore_like)`` hot-reloads the newest checkpoint that
                  passes digests, verification and self-test.  Without them
                  a self-test failure raises.
    """

    def __init__(self, program: BinArrayProgram, *,
                 slo: SLOConfig | None = None,
                 ladder=None,
                 batch_size: int = 4,
                 max_queue: int = 16,
                 max_retries: int = 2,
                 backoff_s: float = 0.01,
                 clock=time.monotonic,
                 sleep=time.sleep,
                 execute_fn=None,
                 initial_rung: int = 0,
                 selftest_every: int | None = None,
                 checkpoint_manager=None,
                 restore_like: BinArrayProgram | None = None):
        if batch_size < 1 or max_queue < 1:
            raise ValueError(f"batch_size ({batch_size}) and max_queue ({max_queue}) "
                             "must be >= 1")
        if selftest_every is not None:
            if selftest_every < 1:
                raise ValueError(f"selftest_every must be >= 1, got {selftest_every}")
            if program.golden is None:
                raise ValueError(
                    "selftest_every requires a program with a GoldenRecord "
                    "(deploy.compile(..., golden=True), the default)")
        self.program = program
        self.batch_size = int(batch_size)
        self.max_queue = int(max_queue)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.clock = clock
        self.sleep = sleep
        self._execute_fn = execute_fn
        self.selftest_every = selftest_every
        self.checkpoint_manager = checkpoint_manager
        self.restore_like = restore_like
        self._last_selftest_batch: int | None = None
        self.last_reload_step: int | None = None
        self.quarantined_program: BinArrayProgram | None = None
        self.controller = SLOController(
            tuple(ladder) if ladder is not None else default_ladder(program),
            slo, initial_rung=initial_rung)
        self.queue: collections.deque[ImageRequest] = collections.deque()
        self._ids = itertools.count()
        self._latencies = collections.deque(maxlen=512)
        self._schedules_seen: set[tuple[int, ...]] = set()
        self.last_batch: torch.Tensor | None = None
        self.last_schedule: tuple[int, ...] | None = None
        self._stats = {
            "admitted": 0, "completed": 0, "failed": 0, "batches": 0,
            "retries": 0, "exec_exceptions": 0, "nonfinite_detected": 0,
            "exec_failed_batches": 0, "shed_count": 0,
            "shed": {r: 0 for r in SHED_REASONS},
            "fault_types": {}, "rung_hist": {},
            "selftest_runs": 0, "selftest_failures": 0, "reloads": 0,
            "quarantined_steps": 0,
        }
        self._last_rung = self.controller.rung

    # ------------------------------------------------------------ admit ---
    def submit(self, image, deadline_s: float | None = None) -> ImageRequest:
        """Admit one image (H, W, C); returns the request (check ``status``).

        Malformed inputs raise ``ValueError`` (caller bug, not load).
        Admission sheds — full queue, dead-on-arrival deadline, controller
        shedding — set ``status="shed"`` + ``shed_reason`` and count in
        ``stats``; they are the explicit backpressure signal.
        """
        image = np.asarray(image, np.float32)
        want = tuple(self.program.input_shape[1:])
        if image.shape != want:
            raise ValueError(
                f"request image has shape {image.shape}; program "
                f"{self.program.arch!r} serves {want} "
                f"(input_shape={self.program.input_shape})")
        req = ImageRequest(image=image, deadline_s=deadline_s,
                           id=next(self._ids), submit_t=self.clock())
        if deadline_s is not None and deadline_s <= req.submit_t:
            return self._shed(req, "deadline_expired")
        if self.controller.shedding and len(self.queue) >= self.batch_size:
            # controller-commanded shedding is backpressure, not an outage:
            # one batch's worth stays admitted so the service keeps serving
            # and measuring, else shedding would latch forever
            return self._shed(req, "slo_shed")
        if len(self.queue) >= self.max_queue:
            return self._shed(req, "queue_full")
        req.status = "queued"
        self.queue.append(req)
        self._stats["admitted"] += 1
        return req

    def _shed(self, req: ImageRequest, reason: str) -> ImageRequest:
        req.status = "shed"
        req.shed_reason = reason
        self._stats["shed"][reason] += 1
        self._stats["shed_count"] += 1
        return req

    # ------------------------------------------------------------- step ---
    def step(self) -> list[ImageRequest]:
        """Serve one batch: assemble, execute at the controller's rung with
        bounded retry, screen for non-finite outputs, record latencies, run
        one SLO update.  Returns every request that left the system this
        step (done, failed, or shed at dispatch).  The watchdog (when
        configured) runs before batch assembly, so a corrupt program is
        replaced before it can answer this step's requests."""
        if self.selftest_every is not None:
            self._watchdog()
        finished: list[ImageRequest] = []
        batch: list[ImageRequest] = []
        while self.queue and len(batch) < self.batch_size:
            req = self.queue.popleft()
            if req.deadline_s is not None and req.deadline_s <= self.clock():
                finished.append(self._shed(req, "deadline_expired"))
                continue
            batch.append(req)
        if not batch:
            return finished

        rung = self.controller.rung
        sched = self.controller.schedule
        shape = (self.batch_size,) + tuple(self.program.input_shape[1:])
        x_np = np.zeros(shape, np.float32)
        for i, req in enumerate(batch):
            x_np[i] = req.image
        x = torch.from_numpy(x_np).to(self.program.device)

        out, err = None, None
        for attempt in range(self.max_retries + 1):
            try:
                y = self._execute(x, sched)
                if not torch.isfinite(y).all().item():
                    self._stats["nonfinite_detected"] += 1
                    raise NonFiniteOutput(
                        f"non-finite logits at rung {rung} (schedule {sched})")
                out = y.cpu()
                break
            except Exception as e:  # noqa: BLE001 — disposition by contract
                # keep its repr, not the exception: its traceback holds this
                # frame, and the cycle would keep the batch and the poisoned
                # output on the device until the cycle collector ran
                err = repr(e)
                name = type(e).__name__
                self._stats["fault_types"][name] = (
                    self._stats["fault_types"].get(name, 0) + 1)
                if not isinstance(e, NonFiniteOutput):
                    self._stats["exec_exceptions"] += 1
                if attempt < self.max_retries:
                    self._stats["retries"] += 1
                    self.sleep(self.backoff_s * (2 ** attempt))

        self._stats["batches"] += 1
        self._stats["rung_hist"][rung] = self._stats["rung_hist"].get(rung, 0) + 1
        self._schedules_seen.add(sched)
        self.last_batch = x
        self.last_schedule = sched

        now = self.clock()
        if out is None:
            # loud failure: requests carry the error, queue keeps draining
            self._stats["exec_failed_batches"] += 1
            for req in batch:
                req.status = "failed"
                req.error = err
                req.rung = rung
                finished.append(req)
        else:
            for i, req in enumerate(batch):
                req.status = "done"
                req.logits = out[i]
                req.m_schedule = sched
                req.rung = rung
                req.batch_index = i
                req.latency_s = now - req.submit_t
                self.controller.observe(req.latency_s)
                self._latencies.append(req.latency_s)
                self._stats["completed"] += 1
                finished.append(req)
        self.controller.update()
        return finished

    # --------------------------------------------------------- watchdog ---
    def _watchdog(self) -> None:
        """Golden self-test on the active rung every ``selftest_every``
        served batches and on every rung change."""
        rung = self.controller.rung
        due = (rung != self._last_rung
               or self._last_selftest_batch is None
               or (self._stats["batches"] - self._last_selftest_batch
                   >= self.selftest_every))
        self._last_rung = rung
        if not due:
            return
        self._last_selftest_batch = self._stats["batches"]
        self._selftest_rungs(self._watch_rungs(self.program))

    def _watch_rungs(self, program):
        """The active rung when the golden record covers it, else full-M
        (rung 0 of golden_rungs, always recorded)."""
        sched = program.resolve_schedule(self.controller.schedule)
        if program.golden.digest_for(sched) is not None:
            return (sched,)
        return (program.resolve_schedule(None),)

    def _selftest_rungs(self, rungs) -> None:
        from repro_torch.deploy.selftest import SelfTestFailure, self_test

        self._stats["selftest_runs"] += 1
        try:
            self_test(self.program, rungs=rungs)
        except SelfTestFailure as e:
            self._stats["selftest_failures"] += 1
            self._recover(e)

    def _recover(self, cause) -> None:
        """Quarantine the live program and hot-reload the last good
        checkpoint.  Loud when recovery is impossible: without a wired
        checkpoint manager the original failure propagates, and an
        exhausted walk raises ``NoGoodCheckpoint``."""
        self.quarantined_program = _on_host(self.program)
        if self.checkpoint_manager is None or self.restore_like is None:
            raise cause
        from repro_torch.deploy.compiler import load_latest_good
        from repro_torch.deploy.selftest import self_test

        before = len(self.checkpoint_manager.quarantined)
        step, fresh = load_latest_good(self.checkpoint_manager, self.restore_like)
        self._stats["quarantined_steps"] += (
            len(self.checkpoint_manager.quarantined) - before)
        # the walk already self-tested every recorded rung; re-run on the
        # rung this service is serving as the explicit resume gate
        self._stats["selftest_runs"] += 1
        self_test(fresh, rungs=self._watch_rungs(fresh))
        self.program = fresh
        self._stats["reloads"] += 1
        self.last_reload_step = step

    def _execute(self, x, sched):
        if self._execute_fn is not None:
            return self._execute_fn(self.program, x, sched)
        # late binding: resolve the module attribute at call time so an
        # inject_faults patch is seen (deploy.execute stays clean)
        from repro_torch.deploy import executor

        return executor.execute(self.program, x, sched)

    def drain(self, max_steps: int = 10_000) -> list[ImageRequest]:
        """Step until the queue is empty; returns everything that finished.
        Bounded (a stuck queue raises instead of spinning forever)."""
        done: list[ImageRequest] = []
        for _ in range(max_steps):
            if not self.queue:
                return done
            done.extend(self.step())
        raise RuntimeError(f"queue failed to drain within {max_steps} steps "
                           f"({len(self.queue)} requests left)")

    # ------------------------------------------------------------ stats ---
    def cache_gauges(self) -> dict:
        """Flat-by-contract gauges for ``testing/soak.py``: the executor's
        (plan picks, loaded kernel libraries, live device bytes on a card)
        plus the service's distinct-schedule count, bounded by the ladder's
        length (a growing value means the controller invents schedules)."""
        from repro_torch.deploy import executor

        gauges = executor.cache_gauges(self.program.device)
        gauges["svc_schedules_seen"] = lambda: float(len(self._schedules_seen))
        return gauges

    @property
    def stats(self) -> dict:
        """Counters, p50/p99 latency over a bounded window, controller
        state.  ``shed`` is by reason, ``fault_types`` by exception class,
        ``rung_hist`` batches served per rung."""
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in self._stats.items()}
        out["queue_depth"] = len(self.queue)
        out["rung"] = self.controller.rung
        out["shedding"] = self.controller.shedding
        lat = sorted(self._latencies)
        if lat:
            out["p50_latency_s"] = lat[len(lat) // 2]
            out["p99_latency_s"] = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        return out
