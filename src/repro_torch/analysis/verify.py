"""verify_program(): statically prove a BinArrayProgram is safe to launch.

Port of ``repro/analysis/verify.py`` with the Hopper rules of
``hopper_rules.py`` in place of the TPU's.  The checker re-derives every
instruction's geometry from the program's ``input_shape`` and static
fields, holds the packed buffers, the frozen plan and the stats against
what the launchers accept and what ``compile`` would make, and re-runs the
canonical plan pick without counting it in ``kernels.ops.plan_pick_count``.
It reads shapes, dtypes and fields only, never tensor values, so it works
on ``deploy.abstract_program`` targets too.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.analysis import hopper_rules
from repro_torch.core.binconv import conv_geometry, same_pads
from repro_torch.deploy.program import (BinArrayProgram, ConvInstr, DWConvInstr,
                                        LinearInstr)
from repro_torch.kernels import binary_conv as bck
from repro_torch.kernels import binary_dwconv as bdw
from repro_torch.kernels import binary_matmul as bmk
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier result: a rule id, where it fired, and why."""

    rule: str        # id in hopper_rules.RULES or TRACE_RULES
    severity: str    # ERROR | WARN
    instr: str       # instruction name ("" = program level)
    index: int       # instruction index (-1 = program level)
    message: str

    def __str__(self) -> str:
        where = f"{self.instr}[{self.index}]" if self.index >= 0 else "program"
        return f"{self.severity} {self.rule} @ {where}: {self.message}"


class ProgramVerificationError(ValueError):
    """Raised by :func:`assert_verified` when ERROR findings exist."""


def make_finding(rule: str, instr: str, index: int, message: str) -> Finding:
    spec = hopper_rules.RULES.get(rule) or hopper_rules.TRACE_RULES[rule]
    return Finding(rule=rule, severity=spec.severity,
                   instr=instr, index=index, message=message)


@contextlib.contextmanager
def _no_pick_accounting():
    """A canonical pick re-run here is not a pick of the program's."""
    before = ops._plan_picks
    try:
        yield
    finally:
        ops._plan_picks = before


def summarize(findings: list[Finding]) -> dict:
    """JSON-able roll-up: ERROR and WARN counts and findings per rule."""
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {"errors": sum(f.severity == hopper_rules.ERROR for f in findings),
            "warnings": sum(f.severity == hopper_rules.WARN for f in findings),
            "by_rule": by_rule}


class _Checker:
    """Findings of one instruction."""

    def __init__(self, program: BinArrayProgram, instr, index: int):
        self.program, self.instr, self.index = program, instr, index
        self.findings: list[Finding] = []

    def add(self, rule: str, message: str) -> None:
        self.findings.append(make_finding(rule, self.instr.name, self.index, message))

    def pre(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        pre = self.instr.pre
        if pre == "flatten":
            n = 1
            for d in shape[1:]:
                n *= d
            return (shape[0], n)
        if pre == "gap":
            return (shape[0], shape[-1])
        if pre != "none":
            self.add("epilogue-pre", f"unknown pre-op {pre!r}")
        return shape

    def tensors(self, packed: str, aligned: bool = False) -> None:
        """Dtype, contiguity and device of the three tensors, as the
        launcher's ``_build.require`` checks them."""
        dev = self.program.device
        for name, dtype in ((packed, torch.uint8), ("alpha", torch.float32),
                            ("bias", torch.float32)):
            t = getattr(self.instr, name)
            if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
                self.add("tensor-layout",
                         f"{name} is {t.dtype} on {t.device} (contiguous: "
                         f"{t.is_contiguous()}); the kernel takes contiguous {dtype} "
                         f"on {dev}")
        if aligned and getattr(self.instr, packed).data_ptr() % 4:
            self.add("tensor-layout", f"{packed} does not start on a 4-byte boundary")

    def levels(self, M: int, max_levels: int | None) -> None:
        if M != self.instr.M:
            self.add("levels-mismatch",
                     f"packed buffer carries {M} levels, instruction says {self.instr.M}")
        if max_levels is not None and M > max_levels:
            self.add("levels-max", f"M={M} > {max_levels}, the most the kernel folds")

    def canonical(self, pick, *args) -> None:
        with _no_pick_accounting():
            want = pick(*args)
        if tuple(self.instr.plan) != tuple(want):
            self.add("plan-noncanonical",
                     f"plan {tuple(self.instr.plan)} != {pick.__name__}{args} = "
                     f"{tuple(want)} (hand-built or stale plan)")

    def stats(self, out_shape, macs: int, weight_bytes: int, padded_in=None) -> None:
        st = self.instr.stats
        for field, got, want in (("out_shape", tuple(st.out_shape), tuple(out_shape)),
                                 ("padded_in", tuple(st.padded_in),
                                  tuple(padded_in or ())),
                                 ("macs", st.macs, macs),
                                 ("weight_bytes", st.weight_bytes, weight_bytes)):
            if got != want:
                self.add("stats-drift", f"stats.{field} {got} != derived {want}")


def _padded(H: int, W: int, kh: int, kw: int, stride: int, padding: str):
    """(Hp, Wp) the compiler records: the map after SAME padding."""
    if padding == "VALID":
        return H, W
    (pt, pb), (pl, pr) = same_pads(H, kh, stride), same_pads(W, kw, stride)
    return H + pt + pb, W + pl + pr


def _verify_conv(program, instr: ConvInstr, idx: int, shape):
    ck = _Checker(program, instr, idx)
    shape = ck.pre(shape)
    if len(shape) != 4:
        ck.add("shape-chain", f"conv needs a rank-4 [B,H,W,C] input, got {shape}")
        return tuple(instr.stats.out_shape), ck.findings
    B, H, W, C = shape
    kh, kw, pool = instr.kh, instr.kw, instr.pool
    tap = instr.B_tap_packed
    if tap.dim() != 4:
        ck.add("pack-width", f"B_tap_packed {tuple(tap.shape)} is not [M, T, C8, D]")
        return tuple(instr.stats.out_shape), ck.findings
    M, T, C8, D = tap.shape
    if T != kh * kw or C8 != -(-C // 8):
        ck.add("pack-width", f"B_tap_packed {tuple(tap.shape)}: want {kh * kw} taps "
               f"of ceil(C/8) = {-(-C // 8)} bytes for C={C}")
    ck.levels(M, bck.MAX_LEVELS)
    K = kh * kw * C
    al = tuple(instr.alpha.shape)
    if len(al) != 3 or al[0] != M or al[2] != D or al[1] * instr.group_size != K:
        ck.add("alpha-shape", f"alpha {al} != [M={M}, G, D={D}] with G * "
               f"group_size={instr.group_size} == K={K}")
    if tuple(instr.bias.shape) != (D,):
        ck.add("alpha-shape", f"bias {tuple(instr.bias.shape)} != ({D},)")
    ck.tensors("B_tap_packed", aligned=True)
    if instr.padding not in ("SAME", "VALID"):
        ck.add("conv-padding", f"padding {instr.padding!r}")
        return tuple(instr.stats.out_shape), ck.findings
    _, (U, V) = conv_geometry(H, W, kh, kw, instr.stride, instr.padding)
    if U < 1 or V < 1 or U % pool or V % pool:
        ck.add("epilogue-pool", f"conv output {U}x{V} is empty or not divisible "
               f"by pool {pool}")
        return tuple(instr.stats.out_shape), ck.findings
    out_shape = (B, U // pool, V // pool, D)
    rows, cols = instr.plan
    if rows not in bck.ROWS or cols not in bck.COLS:
        ck.add("plan-range", f"plan {tuple(instr.plan)}: rows must be one of "
               f"{bck.ROWS}, cols one of {bck.COLS}")
    if pool * pool > rows:
        ck.add("pool-rows", f"a {pool}x{pool} window does not fit {rows} rows")
    if rows > 0 and cols > 0 and bck.shared_bytes(instr.plan) > bck.SHMEM_LIMIT:
        ck.add("shared-memory", f"plan {tuple(instr.plan)} needs "
               f"{bck.shared_bytes(instr.plan)} bytes > {bck.SHMEM_LIMIT}")
    ck.canonical(ops.pick_conv_plan, B * U * V, D, pool)
    ck.stats(out_shape, U * V * D * K, tap.numel() + instr.alpha.numel() * 4,
             _padded(H, W, kh, kw, instr.stride, instr.padding))
    return out_shape, ck.findings


def _verify_dwconv(program, instr: DWConvInstr, idx: int, shape):
    ck = _Checker(program, instr, idx)
    shape = ck.pre(shape)
    if len(shape) != 4:
        ck.add("shape-chain", f"dwconv needs a rank-4 [B,H,W,C] input, got {shape}")
        return tuple(instr.stats.out_shape), ck.findings
    B, H, W, C = shape
    kh, kw = instr.kh, instr.kw
    tap = instr.B_tap_packed
    if tap.dim() != 3 or tap.shape[1] != kh * kw or tap.shape[2] != -(-C // 8):
        ck.add("pack-width", f"B_tap_packed {tuple(tap.shape)} != [M, {kh * kw}, "
               f"ceil(C/8) = {-(-C // 8)}] for C={C}")
        return tuple(instr.stats.out_shape), ck.findings
    M = tap.shape[0]
    ck.levels(M, None)
    if (kh, kw) != (3, 3) or instr.stride not in (1, 2):
        ck.add("dw-geometry", f"{kh}x{kw} at stride {instr.stride}")
    if tuple(instr.alpha.shape) != (M, C):
        ck.add("alpha-shape", f"dw alpha {tuple(instr.alpha.shape)} != (M={M}, C={C})")
    if tuple(instr.bias.shape) != (C,):
        ck.add("alpha-shape", f"bias {tuple(instr.bias.shape)} != ({C},)")
    ck.tensors("B_tap_packed")
    _, (U, V) = conv_geometry(H, W, kh, kw, instr.stride, "SAME")
    out_shape = (B, U, V, C)
    try:
        bdw.check_plan(tuple(instr.plan))
    except ValueError as e:
        ck.add("plan-range", str(e))
    ck.canonical(ops.pick_dwconv_plan, C)
    ck.stats(out_shape, U * V * C * kh * kw, tap.numel() + instr.alpha.numel() * 4,
             _padded(H, W, kh, kw, instr.stride, "SAME"))
    return out_shape, ck.findings


def _verify_linear(program, instr: LinearInstr, idx: int, shape):
    ck = _Checker(program, instr, idx)
    shape = ck.pre(shape)
    K = instr.K
    if len(shape) < 2 or shape[-1] != K:
        ck.add("shape-chain", f"incoming features {shape} (after pre={instr.pre!r}) "
               f"!= instruction K={K}")
    B = shape[0]
    packed = instr.B_packed
    if packed.dim() != 3:
        ck.add("pack-width", f"B_packed {tuple(packed.shape)} is not [M, K8, N]")
        return tuple(instr.stats.out_shape), ck.findings
    M, K8, N = packed.shape
    if K8 != -(-K // 8):
        ck.add("pack-width", f"B_packed width {K8} != ceil(K/8) = {-(-K // 8)} for K={K}")
    ck.levels(M, bmk.MAX_LEVELS)
    al = tuple(instr.alpha.shape)
    if len(al) != 3 or al[0] != M or al[2] != N or al[1] * instr.group_size != K:
        ck.add("alpha-shape", f"alpha {al} != [M={M}, G, N={N}] with G * "
               f"group_size={instr.group_size} == K={K}")
    if tuple(instr.bias.shape) != (N,):
        ck.add("alpha-shape", f"bias {tuple(instr.bias.shape)} != ({N},)")
    ck.tensors("B_packed")
    try:
        bmk.check_plan(tuple(instr.plan))
    except ValueError as e:
        ck.add("plan-range", str(e))
    ck.canonical(ops.pick_matmul_plan, B, N)
    out_shape = (B, N)
    ck.stats(out_shape, K * N, packed.numel() + instr.alpha.numel() * 4)
    return out_shape, ck.findings


_VERIFY = {ConvInstr: _verify_conv, DWConvInstr: _verify_dwconv,
           LinearInstr: _verify_linear}


def verify_program(program: BinArrayProgram) -> list[Finding]:
    """Statically verify every instruction of a compiled (or abstract)
    program.  Returns all findings, ERRORs first; an empty list is clean."""
    findings: list[Finding] = []
    shape = tuple(program.input_shape)
    for idx, instr in enumerate(program.instrs):
        shape, fs = _VERIFY[type(instr)](program, instr, idx, shape)
        findings.extend(fs)
    findings.sort(key=lambda f: (f.severity != hopper_rules.ERROR, f.index))
    return findings


def assert_verified(program: BinArrayProgram) -> list[Finding]:
    """Raise :class:`ProgramVerificationError` on any ERROR finding; returns
    the (WARN-only) findings otherwise."""
    findings = verify_program(program)
    errors = [f for f in findings if f.severity == hopper_rules.ERROR]
    if errors:
        raise ProgramVerificationError(
            f"{len(errors)} ERROR finding(s):\n" + "\n".join(f"  {f}" for f in errors))
    return findings
