"""Mean milliseconds per served step from the end of ``execute`` to the return
of ``step()``: the ``isfinite`` screen, the copy back and the bookkeeping;
CUDA events the benchmark records around the step and, through
``execute_fn``, around the executor (the split of ``serve_timing()`` in
``chip_smoke.py``, copied)."""


def read(ctx):
    rows = ctx.serve_rows
    return sum(r["screen_d2h_ms"] for r in rows) / len(rows) if rows else None
