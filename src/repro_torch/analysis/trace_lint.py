"""Trace lint for ``deploy.execute``: contract checks on the ops one call runs.

Port of ``repro/analysis/trace_lint.py``.  The JAX lint reads a jaxpr; the
port runs the call once under a ``TorchDispatchMode`` that records every
aten op it dispatches.  The mode sees the same ops on the CPU and on the
card, and the CUDA kernels' ctypes launches never appear in it, so on a
card a full-binary ``execute`` shows only the glue around the kernels
(casts, reshapes, the gap mean, bias adds, ReLU, output allocation).

  * **trace-fp-conv** — a full-binary call contains no ``aten.convolution``
    / ``conv2d`` / ``_convolution`` and no ``aten.mm`` / ``addmm`` /
    ``bmm``: every conv went through a binary kernel, and no binary linear
    through a library product.  On the CPU ``execute`` runs the plain
    versions, which go through ``einsum`` (-> ``bmm``) and ``F.conv2d``, so
    there the rule fires by design;
  * **trace-plan-pick** — the call makes no tile-plan pick
    (``kernels.ops.plan_pick_count`` unchanged): all scheduling was frozen
    at compile time.  The counter is snapshot and restored, so linting
    never poisons a caller's own zero-pick gate;
  * **trace-f64** — no float64 output of any op.

Plus **trace-retrace**, the port's counterpart of the JAX retrace
detector: repeated traffic leaves plan picks and loaded kernel libraries
unchanged and launches exactly one kernel per instruction per call on a
card (none on the CPU, where the plain versions run).
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.verify import Finding, make_finding
from repro_torch.kernels import _build, ops

FP_CONV_OPS = frozenset({"convolution", "conv2d", "_convolution"})
LIBRARY_PRODUCT_OPS = frozenset({"mm", "addmm", "bmm"})
KERNEL_OF = {"conv": "binary_conv", "dwconv": "binary_dwconv", "linear": "binary_matmul"}


class _OpRecorder(TorchDispatchMode):
    """Counts the aten ops dispatched inside its scope, by op name, and the
    float64 tensors they return."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter[str] = collections.Counter()
        self.f64 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func.overloadpacket.__name__] += 1
        self.f64 += sum(isinstance(t, torch.Tensor) and t.dtype == torch.float64
                        for t in tree_leaves(out))
        return out


def record_ops(fn, args) -> tuple[collections.Counter, int, int]:
    """Run ``fn(*args)`` once; returns (aten op counts by name, float64
    outputs, plan picks made).  The plan-pick counter is restored."""
    before = ops.plan_pick_count()
    try:
        with _OpRecorder() as rec:
            fn(*args)
        picks = ops.plan_pick_count() - before
    finally:
        ops._plan_picks = before
    return rec.ops, rec.f64, picks


def lint_fn(fn, args, *, full_binary: bool = True,
            label: str = "trace") -> list[Finding]:
    """Run ``fn(*args)`` once under the op recorder and lint what it ran."""
    seen, n64, picks = record_ops(fn, args)
    findings: list[Finding] = []
    if picks:
        findings.append(make_finding(
            "trace-plan-pick", label, -1,
            f"{picks} tile auto-pick(s) ran inside the call — scheduling "
            f"leaked past compile time"))
    library = {n: c for n, c in seen.items()
               if n in FP_CONV_OPS or n in LIBRARY_PRODUCT_OPS}
    if full_binary and library:
        findings.append(make_finding(
            "trace-fp-conv", label, -1,
            f"library conv/product op(s) {dict(sorted(library.items()))} in a "
            f"full-binary call"))
    if n64:
        findings.append(make_finding(
            "trace-f64", label, -1, f"{n64} float64 value(s) in the call"))
    return findings


def lint_execute(program, x=None, *, m_active=None,
                 label: str | None = None) -> list[Finding]:
    """Lint one ``deploy.execute(program, x, m_active)``.  ``x`` defaults to
    zeros of ``program.input_shape`` on the program's device (the call
    executes, so it needs a concrete batch)."""
    from repro_torch.deploy import executor

    if x is None:
        x = torch.zeros(tuple(program.input_shape), device=program.device)
    return lint_fn(lambda p, xx: executor.execute(p, xx, m_active), (program, x),
                   full_binary=True, label=label or f"execute[{program.arch}]")


def retrace_findings(program, x, *, schedules=(None,), repeats: int = 3,
                     label: str | None = None) -> list[Finding]:
    """Run one warm lap and then ``repeats`` laps of the same ``m_active``
    traffic; flag any plan pick (warm lap included), any kernel library
    loaded after the warm lap, and any call whose launches per kernel differ
    from the program's instruction count (a kernel per instruction on a
    card, none on the CPU)."""
    from repro_torch.deploy import executor

    label = label or f"execute[{program.arch}]"
    on_card = program.device.type == "cuda"
    want = {k: 0 for k in ops.launch_counts()}
    for instr in program.instrs:
        want[KERNEL_OF[instr.kind]] += int(on_card)
    picks0 = ops.plan_pick_count()
    bad_calls = []
    libs = None
    for lap in range(1 + repeats):
        for m in schedules:
            before = ops.launch_counts()
            executor.execute(program, x, m)
            if on_card:
                torch.cuda.synchronize(program.device)
            got = {k: v - before[k] for k, v in ops.launch_counts().items()}
            if got != want:
                bad_calls.append((lap, m, got))
        if lap == 0:
            libs = len(_build._libs)
    problems = []
    if ops.plan_pick_count() != picks0:
        problems.append(f"{ops.plan_pick_count() - picks0} plan pick(s)")
    if len(_build._libs) != libs:
        problems.append(f"{len(_build._libs) - libs} kernel librar(ies) loaded "
                        f"after the warm lap")
    if bad_calls:
        lap, m, got = bad_calls[0]
        problems.append(f"{len(bad_calls)} call(s) with launches other than {want}, "
                        f"first lap {lap} m_active={m}: {got}")
    if problems:
        return [make_finding(
            "trace-retrace", label, -1,
            f"{'; '.join(problems)} across {repeats}x repeated traffic of "
            f"{len(schedules)} schedule(s)")]
    return []
