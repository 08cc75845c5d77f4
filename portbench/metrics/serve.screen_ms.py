"""Mean milliseconds per served step of the port's ``serve.screen`` spans (one
per attempt): the host waiting on the card for the batch's kernels, then
the ``isfinite`` screen."""
from portbench import spans


def read(ctx):
    return spans.per_step_ms(spans.card_events(ctx), "serve.screen")
