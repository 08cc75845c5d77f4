"""Mean milliseconds per served step of the port's ``executor.execute`` span:
the host's issue of the program's instructions inside ``step()``, with no
sync inside (beside ``executor.execute_ms.serve``, which is device time
from before the first launch to after the last kernel)."""
from portbench import spans


def read(ctx):
    return spans.per_step_ms(spans.card_events(ctx), "executor.execute")
