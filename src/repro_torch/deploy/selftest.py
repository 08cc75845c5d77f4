"""Golden self-test: the program's built-in self-test (BIST).

Port of ``repro/deploy/selftest.py``.  A flipped bit in ``B_tap_packed``
passes every static check (``analysis.verify_program``) and silently
changes every answer; the defence is a known input with a known answer,
replayed on demand.

``compute_golden`` runs a seeded probe through every §IV-D rung of a
program once and records the CRC32 of each output in a
:class:`~repro_torch.deploy.program.GoldenRecord`; ``self_test`` replays
the probe through ``execute`` and raises :class:`SelfTestFailure` on any
digest mismatch.

The digests are the port's own.  The probe is ``torch.randn`` from a
seeded CPU generator, so it is the same on every machine and is not
stored; but the CUDA kernels and the plain versions each reduce in their
own fixed order, so a digest made on the card never equals one made on
the CPU (nor one the JAX package made).  The record notes the device type
it was made on, and ``self_test`` refuses, with ``ValueError``, a record
from another device type: that says nothing about corruption.

The self-test always measures the clean execute path: the fault
injector's wrapper (``repro_torch.testing.faults``) marks itself with
``_clean_execute``, and :func:`_execute` unwraps it at call time.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import crc32_hex
from repro_torch.deploy.program import BinArrayProgram, GoldenRecord


def _execute(program, x, m_active):
    """The clean executor, unwrapping any live fault-injection patch."""
    from repro_torch.deploy import executor

    fn = executor.execute
    while hasattr(fn, "_clean_execute"):
        fn = fn._clean_execute
    return fn(program, x, m_active)


class SelfTestFailure(RuntimeError):
    """A golden replay produced bytes that no longer match the record."""

    def __init__(self, message: str, *, rung: tuple[int, ...],
                 expected: str, actual: str):
        super().__init__(message)
        self.rung = rung
        self.expected = expected
        self.actual = actual


def golden_rungs(program: BinArrayProgram) -> tuple[tuple[int, ...], ...]:
    """Every §IV-D rung a served program can run at, full-M first: the full
    packed schedule, then for each global m below ``m_max`` the
    front-half-at-m schedule and the global-m schedule.
    ``serve_cnn.slo.default_ladder`` filters this same list, so every
    ladder rung has a recorded digest."""
    full = program.resolve_schedule(None)
    rungs = [full]
    half = len(program.instrs) // 2
    for m in range(program.m_max - 1, 0, -1):
        front = tuple(min(m, s) if i < half else s for i, s in enumerate(full))
        for cand in (front, program.resolve_schedule(m)):
            if cand not in rungs:
                rungs.append(cand)
    return tuple(rungs)


def golden_input(seed: int, input_shape: tuple[int, ...], device) -> torch.Tensor:
    """The probe: standard normal from a CPU generator seeded with
    ``seed``, moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(tuple(input_shape), generator=gen).to(device)


def output_digest(y: torch.Tensor) -> str:
    """CRC32 of the output's contiguous fp32 bytes, copied to the host."""
    return crc32_hex(y.detach().to(torch.float32).contiguous().cpu().numpy().tobytes())


def compute_golden(program: BinArrayProgram, *, seed: int = 0,
                   rungs=None) -> GoldenRecord:
    """Execute the probe at every rung once and record the output digests."""
    if rungs is None:
        rungs = golden_rungs(program)
    shape = (1,) + tuple(program.input_shape[1:])
    x = golden_input(seed, shape, program.device)
    digests = []
    seen = set()
    for r in rungs:
        sched = program.resolve_schedule(r)
        if sched in seen:
            continue
        seen.add(sched)
        digests.append((sched, output_digest(_execute(program, x, sched))))
    return GoldenRecord(seed=seed, input_shape=shape, digests=tuple(digests),
                        device=program.device.type)


def self_test(program: BinArrayProgram, *, rungs=None) -> int:
    """Replay the golden probe; raise :class:`SelfTestFailure` on any
    digest mismatch.  ``rungs=None`` checks every recorded rung; otherwise
    only the given schedules (each must be recorded).  Returns the number
    of rungs checked.  Raises ``ValueError`` when the program has no record
    or its record was made on another device type."""
    rec = program.golden
    if rec is None:
        raise ValueError(
            "program has no GoldenRecord — compile with golden=True (the "
            "default) or attach one made by compute_golden")
    if rec.device != program.device.type:
        raise ValueError(
            f"the GoldenRecord was made on {rec.device!r} and the program runs "
            f"on {program.device.type!r}: digests hold only on the device type "
            "that made them; record new ones with compute_golden")
    if rungs is None:
        targets = rec.schedules()
    else:
        targets = tuple(program.resolve_schedule(r) for r in rungs)
    x = golden_input(rec.seed, rec.input_shape, program.device)
    checked = 0
    for sched in targets:
        want = rec.digest_for(sched)
        if want is None:
            raise ValueError(
                f"schedule {sched} has no recorded golden digest "
                f"(recorded: {list(rec.schedules())})")
        got = output_digest(_execute(program, x, sched))
        if got != want:
            raise SelfTestFailure(
                f"golden self-test failed at rung {sched}: output digest "
                f"{got} != recorded {want} — the program's packed state "
                f"no longer produces its compile-time answers",
                rung=sched, expected=want, actual=got)
        checked += 1
    return checked
