"""The whole program's share of the card's fp32 peak (%), over the traced
window: 2 FLOPs per dense multiply-accumulate of every layer, per image,
times the images of the calls the window made, over the window's length
(the trace's, first span to the end of the last device span) times the
peak."""
from portbench import network, peaks


def read(ctx):
    if ctx.split is None or not ctx.calls:
        return None
    flops = 2 * network.macs_per_image(ctx.net) * ctx.batch * ctx.calls
    return 100.0 * flops / (ctx.split["window_us"] * 1e-6 * peaks.FP32_FLOPS)
