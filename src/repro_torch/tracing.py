"""Spans of the serving path, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler is recording, and one shared no-op context otherwise: off, a span
costs one check of ``torch.autograd._profiler_enabled()`` and makes no
range, no object and no string.  There is no switch of its own and no
exporter: the profiler is the switch and its trace is the export, so the
spans land beside the kernels they launch, on the same clock.

The spans (each ``serve.*`` is a direct child of ``serve.step``):

    serve.step                  one call of ``CNNService.step``
      serve.assemble            queue pops, deadline checks, the host batch
      serve.h2d                 the batch's copy to the program's device
      executor.execute          ``deploy.executor.execute``: the host's issue
        executor.<instr name>   one per instruction (its index when unnamed)
      serve.screen              the wait for the batch and its finite screen,
                                one per attempt that reached it
      serve.d2h                 the logits' copy back

To profile a live ``CNNService``::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            svc.step()
    prof.export_chrome_trace("serve.json")   # spans over the kernels

Under Nsight Systems, ``nsys profile`` of a process that serves inside
``torch.autograd.profiler.emit_nvtx()`` shows the same ranges as NVTX.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a torch profiler (or ``emit_nvtx``) is recording."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    return torch.profiler.record_function(name) if enabled() else _OFF
