"""The 95th percentile (nearest rank, ``check.p95``) of ``serve.step``: the
port's span around each ``CNNService.step()`` in the profiled part of the
traced window (ms)."""
from portbench import check, spans


def read(ctx):
    steps = spans.step_ms(spans.card_events(ctx))
    return check.p95(steps) if steps else None
