"""Mean milliseconds per served step of the port's ``serve.assemble`` span:
the queue pops with their deadline checks and the batch's assembly in a
pageable numpy array, on the host."""
from portbench import spans


def read(ctx):
    return spans.per_step_ms(spans.card_events(ctx), "serve.assemble")
