"""The card's idle share (%) over the traced window of a serve cell: one
minus the union of its device spans over the window (``device_split``)."""


def read(ctx):
    return None if ctx.split is None else 100.0 * ctx.split["idle_share"]
