"""Mean milliseconds per served step from the start of ``CNNService.step()`` to
the start of its ``execute``: batch assembly in a pageable numpy array and
the copy to the card; CUDA events the benchmark records around the step and,
through ``execute_fn``, around the executor (the split of ``serve_timing()``
in ``chip_smoke.py``, copied)."""


def read(ctx):
    rows = ctx.serve_rows
    return sum(r["assemble_h2d_ms"] for r in rows) / len(rows) if rows else None
