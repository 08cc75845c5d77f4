"""SLO controller: map latency pressure onto the §IV-D degradation ladder.

Port of ``repro/serve_cnn/slo.py`` (plain Python, pointed at the port's
program).  Under latency pressure the service serves fewer binary levels
before it sheds requests, and recovers to full-M when the pressure clears:

  * :func:`schedule_cost` — the §IV-E cost of a resolved ``m_active``
    schedule: level-weighted MACs (one pass per active level per layer).
  * :func:`default_ladder` — per-layer schedules with strictly decreasing
    cost, full-M first; front-half-reduced rungs before global reductions
    (late layers carry the accuracy).
  * :class:`SLOController` — windowed-quantile feedback: ``observe()``
    completion latencies, ``update()`` once per batch.  Pressure =
    p99/target; at ``degrade_at`` one rung down (then shedding at admission
    once the ladder is exhausted); after ``recover_after`` calm updates one
    rung back up.  The sample window is cleared on every rung change, so
    the next decision measures the new rung only.
"""
from __future__ import annotations

import collections
import dataclasses

from repro_torch.deploy.program import BinArrayProgram


def schedule_cost(program: BinArrayProgram, m_active=None) -> int:
    """Level-weighted MAC cost of running ``program`` at ``m_active``.

    One binary-matmul pass per active level per layer (paper §IV-E), so the
    cost of a schedule is ``sum(layer.macs * m_layer)``.  Accepts anything
    ``resolve_schedule`` does (None | int | per-layer sequence).
    """
    sched = program.resolve_schedule(m_active)
    return sum(int(i.stats.macs) * m for i, m in zip(program.instrs, sched))


def default_ladder(program: BinArrayProgram) -> tuple[tuple[int, ...], ...]:
    """Build the degradation ladder: resolved per-layer schedules, full-M
    first, strictly decreasing :func:`schedule_cost`, no duplicates.

    Rung 0 is always the full packed schedule.  Below it, for each global
    level count m < m_max, two candidates in order: front-half layers at m
    with the back half kept full (the accuracy-gentle rung), then the global
    §IV-D switch at m.  Candidates that do not strictly reduce cost (tiny or
    already-M=1 programs) are dropped, so every program gets a valid ladder —
    possibly of length 1, in which case the controller's only move is shed.

    The candidate list is ``deploy.selftest.golden_rungs`` — the same rungs
    ``deploy.compile`` records golden digests for — so every ladder rung the
    service can run at is guaranteed a recorded BIST digest.
    """
    from repro_torch.deploy.selftest import golden_rungs
    ladder = []
    for cand in golden_rungs(program):
        if not ladder or schedule_cost(program, cand) < schedule_cost(
                program, ladder[-1]):
            ladder.append(cand)
    return tuple(ladder)


@dataclasses.dataclass
class SLOConfig:
    """Feedback-policy knobs for :class:`SLOController`.

    ``target_ms=None`` disables the loop entirely: the controller pins its
    initial rung and never sheds (static-schedule serving — benches and
    bit-exactness tests use this).  ``degrade_at``/``recover_at`` are
    pressure thresholds (pressure = windowed p-``quantile`` latency /
    target); the gap between them plus ``recover_after`` consecutive calm
    updates is the hysteresis that stops rung flapping.
    """

    target_ms: float | None = None
    window: int = 64            # latency samples retained (deque maxlen)
    min_samples: int = 8        # no decisions until the window has this many
    degrade_at: float = 1.0     # pressure >= this -> one rung down
    recover_at: float = 0.6     # pressure <= this counts as a calm update
    recover_after: int = 3      # consecutive calm updates before climbing
    quantile: float = 0.99


class SLOController:
    """Windowed-quantile latency feedback over a degradation ladder.

    State: ``rung`` indexes ``ladder`` (0 = full-M); ``shedding`` is the
    final escalation past the last rung — the service consults it at
    admission.  ``rung_changes`` / ``shed_transitions`` are monotone
    counters for the soak progress report.
    """

    def __init__(self, ladder: tuple[tuple[int, ...], ...],
                 config: SLOConfig | None = None, *, initial_rung: int = 0):
        if not ladder:
            raise ValueError("ladder must hold at least one schedule")
        if not 0 <= initial_rung < len(ladder):
            raise ValueError(
                f"initial_rung {initial_rung} outside ladder of "
                f"{len(ladder)} rungs")
        self.ladder = tuple(ladder)
        self.config = config or SLOConfig()
        self.rung = initial_rung
        self.shedding = False
        self.rung_changes = 0
        self.shed_transitions = 0
        self._window = collections.deque(maxlen=self.config.window)
        self._calm = 0

    @property
    def schedule(self) -> tuple[int, ...]:
        """The per-layer ``m_active`` schedule of the current rung."""
        return self.ladder[self.rung]

    def observe(self, latency_s: float) -> None:
        """Record one request completion latency (seconds)."""
        self._window.append(float(latency_s))

    def pressure(self) -> float | None:
        """Windowed p-quantile latency over target, or None when the loop
        is disabled (no target) or the window is still too thin."""
        cfg = self.config
        if cfg.target_ms is None or len(self._window) < cfg.min_samples:
            return None
        lat = sorted(self._window)
        idx = min(len(lat) - 1, int(cfg.quantile * len(lat)))
        return lat[idx] / (cfg.target_ms * 1e-3)

    def update(self) -> None:
        """One control decision (call once per served batch).

        Escalation clears the sample window so the next decision measures
        the *new* rung, not a mix; de-escalation requires ``recover_after``
        consecutive calm updates and likewise resets the window.
        """
        p = self.pressure()
        if p is None:
            return
        cfg = self.config
        if p >= cfg.degrade_at:
            self._calm = 0
            if self.rung + 1 < len(self.ladder):
                self.rung += 1
                self.rung_changes += 1
                self._window.clear()
            elif not self.shedding:
                self.shedding = True
                self.shed_transitions += 1
                self._window.clear()
        elif p <= cfg.recover_at:
            self._calm += 1
            if self._calm >= cfg.recover_after:
                self._calm = 0
                if self.shedding:
                    self.shedding = False
                    self.shed_transitions += 1
                elif self.rung > 0:
                    self.rung -= 1
                    self.rung_changes += 1
                    self._window.clear()
        else:
            self._calm = 0
