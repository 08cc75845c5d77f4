"""A kernel's share of its roofline, read from the traced window.

The least time the card could take over the window is, for each launch of
the kernel, the larger of its FLOPs over the fp32 peak and its bytes over
the HBM peak (``network.work``); the share is that sum over the kernel's
device time by name in the trace, in percent.
"""
from __future__ import annotations

import sys

from portbench import devtrace, network, peaks


def share(ctx, kernel: str, kinds: tuple[str, ...]) -> float | None:
    """Percent of ``kernel``'s roofline over ``ctx``'s traced window, for the
    layers of ``kinds``; None where the trace holds none of its launches or
    the launches do not match the calls the window made."""
    layers = [(layer, m) for layer, m in zip(ctx.net, ctx.sched) if layer.kind in kinds]
    spans = devtrace.device_events(ctx.events, kernel)
    if not layers or not spans or not ctx.calls:
        return None
    if len(spans) != ctx.calls * len(layers):
        print(f"{kernel}: {len(spans)} launches in the trace for {ctx.calls} calls of "
              f"{len(layers)} layers; roofline not read", file=sys.stderr)
        return None
    bound_s = 0.0
    for layer, m in layers:
        nbytes, flops = network.work(layer, ctx.batch, m)
        bound_s += max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    device_s = sum(float(e["dur"]) for e in spans) * 1e-6
    return 100.0 * ctx.calls * bound_s / device_s
