"""Mean milliseconds per served step of ``serve.step`` that none of its five
children (``serve.assemble``, ``serve.h2d``, ``executor.execute``,
``serve.screen``, ``serve.d2h``) covers: per-request bookkeeping, the SLO
controller's update and retry sleeps."""
from portbench import spans


def read(ctx):
    return spans.step_self_ms(spans.card_events(ctx))
