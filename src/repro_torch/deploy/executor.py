"""execute(): run a compiled BinArrayProgram (port of ``repro/deploy/executor.py``).

A loop over the instruction stream.  Every tile plan was frozen at compile
time, so the loop makes no plan pick (``kernels.ops.plan_pick_count`` is the
proof hook).  The per-call degrees of freedom are the batch size and the
§IV-D ``m_active`` schedule: None (all packed levels), an int (global,
clamped per instruction), or one entry per instruction.

On a program whose tensors live on a card each instruction launches its
CUDA kernel; on a CPU program the same loop runs the plain versions.
``execute_reference`` runs the loop through the plain versions wherever the
program lives — the yardstick the tests and ``chip_smoke.py`` hold
``execute`` against.

While a torch profiler records, ``execute`` runs inside the span
``executor.execute`` and each instruction inside ``executor.<name>``
(``repro_torch.tracing``); with none it makes no span.

``cache_stats`` / ``cache_gauges`` are the counterparts of the JAX
executor's jit-cache counters for ``testing/soak.py``.  The port has no
jit cache, so they gauge what could grow under traffic instead: plan picks
(``execute`` makes none), loaded kernel libraries (at most one per CUDA
source) and, on a card, live device bytes.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.deploy.program import (BinArrayProgram, ConvInstr, DWConvInstr,
                                        LinearInstr)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as kref
from repro_torch.models.cnn import apply_pre


def cache_stats(device=None) -> dict:
    """The executor's gauges as numbers: ``plan_picks``
    (``ops.plan_pick_count()``), ``kernel_libs`` (libraries loaded by
    ``kernels/_build.py``), ``live_bytes`` (``torch.cuda.memory_allocated``)
    when ``device`` is a CUDA device, and ``launches``
    (``ops.launch_counts()``), which is progress and grows by design."""
    out = {"plan_picks": ops.plan_pick_count(), "kernel_libs": len(_build._libs)}
    if device is not None and torch.device(device).type == "cuda":
        out["live_bytes"] = torch.cuda.memory_allocated(torch.device(device))
    out["launches"] = ops.launch_counts()
    return out


def cache_gauges(device=None) -> dict:
    """``name -> callable`` gauges for ``testing/soak.py``, each exactly flat
    once a workload has seen all its variants; ``device`` as in
    :func:`cache_stats` (live bytes are gauged on a card only)."""
    gauges = {"exec_plan_picks": lambda: float(ops.plan_pick_count()),
              "exec_kernel_libs": lambda: float(len(_build._libs))}
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        gauges["exec_live_bytes"] = lambda: float(torch.cuda.memory_allocated(dev))
    return gauges


def _apply(instr, y: torch.Tensor, m: int) -> torch.Tensor:
    y = apply_pre(instr.pre, y)
    if isinstance(instr, ConvInstr):
        return ops.binary_conv2d(
            y, instr.B_tap_packed, instr.alpha, instr.bias, kh=instr.kh, kw=instr.kw,
            stride=instr.stride, padding=instr.padding, pool=instr.pool, m_active=m,
            relu=instr.relu, plan=instr.plan)
    if isinstance(instr, DWConvInstr):
        return ops.binary_dwconv2d(
            y, instr.B_tap_packed, instr.alpha, instr.bias, kh=instr.kh, kw=instr.kw,
            stride=instr.stride, m_active=m, relu=instr.relu, plan=instr.plan)
    assert isinstance(instr, LinearInstr), instr
    out = ops.binary_matmul(y, instr.B_packed, instr.alpha, K=instr.K,
                            group_size=instr.group_size, m_active=m, plan=instr.plan)
    out = out + instr.bias
    return torch.relu(out) if instr.relu else out


def _apply_reference(instr, y: torch.Tensor, m: int) -> torch.Tensor:
    y = apply_pre(instr.pre, y)
    if isinstance(instr, ConvInstr):
        return kref.fused_binary_conv_relu_pool_ref(
            y, instr.B_tap_packed, instr.alpha, kh=instr.kh, kw=instr.kw,
            stride=instr.stride, padding=instr.padding, pool=instr.pool, m_active=m,
            bias=instr.bias, relu=instr.relu)
    if isinstance(instr, DWConvInstr):
        return kref.binary_dwconv_relu_ref(
            y, instr.B_tap_packed, instr.alpha, kh=instr.kh, kw=instr.kw,
            stride=instr.stride, padding="SAME", m_active=m, bias=instr.bias,
            relu=instr.relu)
    assert isinstance(instr, LinearInstr), instr
    out = kref.binary_matmul_ref(y, instr.B_packed, instr.alpha, K=instr.K,
                                 group_size=instr.group_size, m_active=m)
    out = out + instr.bias
    return torch.relu(out) if instr.relu else out


def _check_input(program: BinArrayProgram, x) -> None:
    """Validate ``x`` before the first kernel: rank, per-image dims and a
    floating dtype must match the program (the batch dim is free), and it
    must live on the program's device."""
    want = tuple(program.input_shape)
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) != len(want) or shape[1:] != want[1:]:
        raise ValueError(
            f"input shape {shape} does not match program {program.arch!r}: "
            f"expected (B,{','.join(map(str, want[1:]))}) "
            f"(compiled input_shape={want}; batch dim is free)")
    if not torch.is_floating_point(x):
        raise ValueError(f"input dtype {x.dtype} is not floating; program "
                         f"{program.arch!r} executes fp activations")
    if x.device != program.device:
        raise ValueError(f"input is on {x.device}, program on {program.device}")


def _run(program: BinArrayProgram, x: torch.Tensor, m_active, apply,
         traced: bool = False) -> torch.Tensor:
    _check_input(program, x)
    y = x.to(torch.float32)
    for i, (instr, m) in enumerate(zip(program.instrs,
                                       program.resolve_schedule(m_active))):
        if traced:
            with tracing.span(f"executor.{instr.name or i}"):
                y = apply(instr, y, m)
        else:
            y = apply(instr, y, m)
    return y


def execute(program: BinArrayProgram, x: torch.Tensor, m_active=None) -> torch.Tensor:
    """Run the program on a batch: x [B, H, W, C] -> logits [B, classes]."""
    if not tracing.enabled():
        return _run(program, x, m_active, _apply)
    with tracing.span("executor.execute"):
        return _run(program, x, m_active, _apply, traced=True)


def execute_reference(program: BinArrayProgram, x: torch.Tensor,
                      m_active=None) -> torch.Tensor:
    """The same loop through the plain PyTorch versions (``kernels/ref.py``)."""
    return _run(program, x, m_active, _apply_reference)
