"""Mean milliseconds per served step of the port's ``serve.h2d`` span: the
batch's copy from pageable host memory to the card."""
from portbench import spans


def read(ctx):
    return spans.per_step_ms(spans.card_events(ctx), "serve.h2d")
