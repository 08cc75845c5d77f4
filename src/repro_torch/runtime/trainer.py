"""Fault-tolerant training loop (port of ``repro/runtime/trainer.py``).

  * checkpoint every N steps and at the last step (atomic, through the
    port's ``CheckpointManager``; the data pipeline's state included);
  * auto-resume: ``maybe_resume`` restores the latest complete checkpoint
    and fast-forwards the data pipeline, so a killed job restarted with the
    same command continues bit-exactly (on the card only with
    ``torch.use_deterministic_algorithms(True)``);
  * straggler watchdog: a step slower than ``straggler_factor`` times the
    EWMA of earlier steps is recorded (the first step, which builds what it
    needs, stays out of the EWMA);
  * elastic re-mesh: with ``state_shardings`` (``launch/steps.
    train_state_shardings`` of the mesh it runs on), ``maybe_resume``
    restores onto that mesh whatever mesh saved the checkpoint
    (reshard-on-restore, ``checkpoint/manager.py``).  On a mesh every rank
    runs the trainer: the saves are collectives and rank 0 writes;
  * NaN/inf guard: a step whose loss is not finite is counted in
    ``nan_skips`` and its update skipped.  The port updates in place, so
    ``step_fn`` must decide before it updates (``launch/steps.py``'s does);
    the trainer keeps whatever state ``step_fn`` returns.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"   # relative to the working directory
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0   # deadline = EWMA * factor
    ewma_decay: float = 0.9
    log_every: int = 10


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    resumed_from: int | None = None
    straggler_events: list = dataclasses.field(default_factory=list)
    nan_skips: int = 0
    losses: list = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(self, step_fn: Callable, state: Any, data, tcfg: TrainerConfig, *,
                 state_shardings=None):
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.tcfg = tcfg
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self.report = TrainerReport()
        self.state_shardings = state_shardings

    # ------------------------------------------------------------ resume --
    def maybe_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.state, extra = self.ckpt.restore(latest, self.state,
                                              shardings=self.state_shardings)
        if "data_state" in extra and hasattr(self.data, "load_state_dict"):
            self.data.load_state_dict(extra["data_state"])
        self.report.resumed_from = latest
        log.info("resumed from checkpoint step %d", latest)
        return True

    # -------------------------------------------------------------- loop --
    def run(self) -> TrainerReport:
        t = self.tcfg
        ewma = None
        first_iter = True  # the first step builds kernels and caches: kept out of the EWMA
        for step in range(int(self.state["step"]), t.total_steps):
            batch = self.data.next_batch()
            t0 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            # --- NaN guard: step_fn skipped the update ---
            if not math.isfinite(loss):
                self.report.nan_skips += 1
                log.warning("step %d: non-finite loss %s, update skipped", step, loss)
            else:
                self.report.losses.append(loss)
            # --- straggler watchdog ---
            if ewma is not None and dt > t.straggler_factor * ewma:
                self.report.straggler_events.append(
                    {"step": step, "seconds": dt, "deadline": t.straggler_factor * ewma})
                log.warning("step %d straggled: %.3fs (deadline %.3fs)",
                            step, dt, t.straggler_factor * ewma)
            if first_iter:
                first_iter = False
            else:
                ewma = dt if ewma is None else t.ewma_decay * ewma + (1 - t.ewma_decay) * dt
            self.report.steps_run += 1
            if step % t.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
            # --- checkpoint ---
            if (step + 1) % t.checkpoint_every == 0 or step + 1 == t.total_steps:
                extra = {}
                if hasattr(self.data, "state_dict"):
                    extra["data_state"] = self.data.state_dict()
                self.ckpt.save(step + 1, self.state, extra=extra)
        return self.report
