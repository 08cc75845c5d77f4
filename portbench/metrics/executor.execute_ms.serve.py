"""Mean milliseconds per served step of ``repro_torch.deploy.executor.execute``
inside ``step()``: the host's issue of its launches and their device time;
CUDA events the benchmark records around the step and, through
``execute_fn``, around the executor (the split of ``serve_timing()`` in
``chip_smoke.py``, copied)."""


def read(ctx):
    rows = ctx.serve_rows
    return sum(r["execute_ms"] for r in rows) / len(rows) if rows else None
