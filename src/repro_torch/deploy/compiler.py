"""compile(): layer params + arch -> BinArrayProgram (paper §IV).

Port of ``repro/deploy/compiler.py`` ``compile``.  Everything static is
done once, here:

  1. **Pack** — fp trees are binarized (Algorithm 2) into the kernels'
     packed layouts; packed trees are reused as they are, a conv that
     carries only the flat ``B_packed`` stream repacked per tap
     (``kernels/binary_conv.repack_taps``).
  2. **Plan** — one Hopper tile plan per instruction, picked for the
     compile-time ``input_shape`` by ``kernels/ops.py``'s pick functions
     (each pick bumps ``plan_pick_count()``) and frozen into the
     instruction, so ``execute`` picks nothing.
  3. **Account** — shapes, MACs and packed weight bytes in ``LayerStats``.
  4. **Attest** — a :class:`GoldenRecord` of the program's own outputs at
     every §IV-D rung (``deploy/selftest.py``), unless ``golden=False``.

Below ``compile``: ``abstract_program`` (a restore target built without
binarizing anything) and the checkpoint round trip through
``checkpoint/manager.py`` (``save_program`` / ``load_program`` /
``load_latest_good``), in the JAX package's on-disk format.  The port's
golden record travels in the manifest under ``"golden_torch"``, never the
JAX package's ``"golden"``: each package only attaches its own.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import binconv
from repro_torch.core import binlinear as bl
from repro_torch.core.binlinear import QuantConfig
from repro_torch.deploy.program import (BinArrayProgram, ConvInstr, DWConvInstr,
                                        GoldenRecord, LayerStats, LinearInstr,
                                        TilePlan)
from repro_torch.kernels import binary_conv as bck
from repro_torch.kernels import ops
from repro_torch.models import cnn

ARCHS = ("cnn_a", "mobilenet")


def _specs(arch):
    if isinstance(arch, (tuple, list)):
        return tuple(arch)
    if arch == "cnn_a":
        return cnn.CNN_A_SPECS
    if arch == "mobilenet":
        return cnn.MOBILENET_SPECS
    raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS} "
                     "or an explicit LayerSpec sequence")


def _on(t: torch.Tensor, dtype, dev: torch.device) -> torch.Tensor:
    return t.to(device=dev, dtype=dtype).contiguous()


def _bias(p: dict, n: int, dev: torch.device) -> torch.Tensor:
    b = p.get("b")
    return torch.zeros(n, device=dev) if b is None else _on(b, torch.float32, dev)


def _compile_conv(spec, p, shape, quant, dev):
    B, H, W, C = shape
    if "B_tap_packed" not in p:
        if "B_packed" in p:      # a flat-only packed tree: upgrade its layout once
            p = dict(p, B_tap_packed=bck.repack_taps(p["B_packed"], spec.kh, spec.kw, C))
        else:
            p = binconv.binarize_conv_params(p, quant)
    tap = _on(p["B_tap_packed"], torch.uint8, dev)
    M, T, C8, D = tap.shape
    kh, kw = spec.kh, spec.kw
    if T != kh * kw or C8 != -(-C // 8):
        raise ValueError(f"{spec.name}: B_tap_packed {tuple(tap.shape)} does not "
                         f"fit a {kh}x{kw} conv over C={C}")
    if spec.padding == "SAME":
        (pt, pb), (pl, pr) = (binconv.same_pads(H, kh, spec.stride),
                              binconv.same_pads(W, kw, spec.stride))
        Hp, Wp = H + pt + pb, W + pl + pr
    else:
        Hp, Wp = H, W
    U = (Hp - kh) // spec.stride + 1
    V = (Wp - kw) // spec.stride + 1
    if U % spec.pool or V % spec.pool:
        raise ValueError(
            f"{spec.name}: conv output {U}x{V} not divisible by AMU pool "
            f"{spec.pool} (paper §III-B: downsampling only)")
    alpha = _on(p["alpha"], torch.float32, dev)
    out_shape = (B, U // spec.pool, V // spec.pool, D)
    stats = LayerStats(in_shape=(B, H, W, C), out_shape=out_shape, padded_in=(Hp, Wp),
                       macs=U * V * D * kh * kw * C,
                       weight_bytes=tap.numel() + alpha.numel() * 4)
    plan = TilePlan(*ops.pick_conv_plan(B * U * V, D, spec.pool))
    instr = ConvInstr(
        B_tap_packed=tap, alpha=alpha, bias=_bias(p, D, dev), name=spec.name,
        kh=kh, kw=kw, stride=spec.stride, padding=spec.padding, pool=spec.pool,
        relu=spec.relu, pre=spec.pre, M=M, group_size=kh * kw * C // alpha.shape[1],
        plan=plan, stats=stats)
    return instr, out_shape


def _compile_dwconv(spec, p, shape, quant, dev):
    if "B_tap_packed" not in p:
        p = binconv.binarize_dwconv_params(p, quant)
    B, H, W, C = shape
    tap = _on(p["B_tap_packed"], torch.uint8, dev)
    M, T, c8 = tap.shape
    kh, kw = spec.kh, spec.kw
    if T != kh * kw or c8 != -(-C // 8):
        raise ValueError(f"{spec.name}: B_tap_packed {tuple(tap.shape)} does not "
                         f"fit a {kh}x{kw} depth-wise conv over C={C}")
    (pt, pb), (pl, pr) = (binconv.same_pads(H, kh, spec.stride),
                          binconv.same_pads(W, kw, spec.stride))
    Hp, Wp = H + pt + pb, W + pl + pr
    U = (Hp - kh) // spec.stride + 1
    V = (Wp - kw) // spec.stride + 1
    alpha = _on(p["alpha"], torch.float32, dev)
    stats = LayerStats(in_shape=(B, H, W, C), out_shape=(B, U, V, C), padded_in=(Hp, Wp),
                       macs=U * V * C * kh * kw,
                       weight_bytes=tap.numel() + alpha.numel() * 4)
    instr = DWConvInstr(
        B_tap_packed=tap, alpha=alpha, bias=_bias(p, C, dev), name=spec.name,
        kh=kh, kw=kw, stride=spec.stride, relu=spec.relu, pre=spec.pre, M=M,
        plan=TilePlan(*ops.pick_dwconv_plan(C)), stats=stats)
    return instr, stats.out_shape


def _compile_linear(spec, p, shape, quant, dev):
    if "B_packed" not in p:
        p = bl.binarize_params(p, quant)
    B = shape[0]
    if spec.pre == "flatten":
        K = 1
        for d in shape[1:]:
            K *= d
    else:  # "gap" (channels survive the mean) or "none" (already [B, K])
        K = shape[-1]
    packed = _on(p["B_packed"], torch.uint8, dev)
    alpha = _on(p["alpha"], torch.float32, dev)
    M, K8, N = packed.shape
    if K8 != -(-K // 8):
        raise ValueError(f"{spec.name}: B_packed {tuple(packed.shape)} does not fit K={K}")
    stats = LayerStats(in_shape=(B, K), out_shape=(B, N), macs=K * N,
                       weight_bytes=packed.numel() + alpha.numel() * 4)
    instr = LinearInstr(
        B_packed=packed, alpha=alpha, bias=_bias(p, N, dev), name=spec.name, K=K,
        relu=spec.relu, pre=spec.pre, M=M, group_size=K // alpha.shape[1],
        plan=TilePlan(*ops.pick_matmul_plan(B, N)), stats=stats)
    return instr, stats.out_shape


def compile(params: dict, arch, quant: QuantConfig, input_shape: tuple[int, ...], *,
            device="cuda", golden: bool | int = True,
            verify: bool = False) -> BinArrayProgram:
    """Compile a network into a :class:`BinArrayProgram` on ``device``.

    params:      fp tree (binarized here with ``quant``) or a packed tree
                 (``B_tap_packed``/``B_packed``, ``alpha``, ``b``), reused as
                 it is; both come from ``models/cnn.py`` or ``convert.py``.
    arch:        "cnn_a" | "mobilenet" or an explicit LayerSpec sequence.
    input_shape: (B, H, W, C) the tile plans are picked for.
    golden:      record a :class:`GoldenRecord` (``deploy/selftest.py``):
                 True uses probe seed 0, an int is the seed, False skips it.
    verify:      run ``repro_torch.analysis.verify_program`` and raise
                 ``ProgramVerificationError`` on any ERROR finding.
    """
    dev = resolve_device(device)
    if len(input_shape) != 4:
        raise ValueError(f"input_shape must be (B, H, W, C): {input_shape}")
    shape = tuple(int(d) for d in input_shape)
    instrs = []
    for spec in _specs(arch):
        p = params[spec.name]
        if spec.kind == "conv":
            instr, shape = _compile_conv(spec, p, shape, quant, dev)
        elif spec.kind == "dwconv":
            instr, shape = _compile_dwconv(spec, p, shape, quant, dev)
        else:
            instr, shape = _compile_linear(spec, p, shape, quant, dev)
        instrs.append(instr)
    program = BinArrayProgram(instrs=tuple(instrs),
                              arch=arch if isinstance(arch, str) else "custom",
                              input_shape=tuple(int(d) for d in input_shape))
    if golden is not False:
        from repro_torch.deploy.selftest import compute_golden

        seed = 0 if golden is True else int(golden)
        program = dataclasses.replace(program, golden=compute_golden(program, seed=seed))
    if verify:
        from repro_torch.analysis.verify import assert_verified

        assert_verified(program)
    return program


def _empty_packed(spec, w_shape, quant: QuantConfig, dev: torch.device) -> dict:
    """Uninitialised tensors of the packed layer ``compile`` would make from
    fp weights of ``w_shape``."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    M = quant.M
    if spec.kind == "conv":
        kh, kw, C, D = w_shape
        K = kh * kw * C
        G = 1 if quant.group_size is None else K // quant.group_size
        return {"B_tap_packed": empty(M, kh * kw, -(-C // 8), D, dtype=torch.uint8),
                "alpha": empty(M, G, D), "b": empty(D)}
    if spec.kind == "dwconv":
        kh, kw, _, C = w_shape
        return {"B_tap_packed": empty(M, kh * kw, -(-C // 8), dtype=torch.uint8),
                "alpha": empty(M, C), "b": empty(C)}
    K, N = w_shape
    G = 1 if quant.group_size is None else K // quant.group_size
    return {"B_packed": empty(M, -(-K // 8), N, dtype=torch.uint8),
            "alpha": empty(M, G, N), "b": empty(N)}


def abstract_program(arch: str, quant: QuantConfig, input_shape: tuple[int, ...], *,
                     width_mult: float = 1.0, n_classes: int = 1000,
                     device="cuda") -> BinArrayProgram:
    """The program ``compile`` would make for ``arch`` at ``input_shape``:
    the same instructions, plans and stats, with uninitialised tensors of
    the packed shapes on ``device`` and no golden record.  No binarization
    runs.  It is the restore target of :func:`load_program`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    if arch == "cnn_a":
        fp = cnn.init_cnn_a(gen, device="cpu")
    elif arch == "mobilenet":
        fp = cnn.init_mobilenet(gen, width_mult=width_mult, n_classes=n_classes,
                                device="cpu")
    else:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    packed = {s.name: _empty_packed(s, tuple(fp[s.name]["w"].shape), quant, dev)
              for s in _specs(arch)}
    return compile(packed, arch, quant, input_shape, device=dev, golden=False)


# ---------------------------------------------------------------------------
# Checkpoint round trip (checkpoint/manager.py)
# ---------------------------------------------------------------------------

GOLDEN_KEY = "golden_torch"   # manifest ``extra`` key of the port's record


def save_program(manager, step: int, program: BinArrayProgram, *,
                 extra: dict | None = None) -> str:
    """Persist a compiled program's tensors under ``program/...``; plans and
    stats come back from the restore target.  The program's
    :class:`GoldenRecord` goes into the digest-protected manifest under
    ``"golden_torch"``, so :func:`load_program` re-attaches it to an
    abstract target."""
    meta = {"deploy": program.totals()}
    if program.golden is not None:
        meta[GOLDEN_KEY] = program.golden.to_json()
    meta.update(extra or {})
    return manager.save(step, {"program": program}, extra=meta)


def _attach_golden(program: BinArrayProgram, extra) -> BinArrayProgram:
    """Re-attach the manifest's port golden record when the restore target
    had none (restore takes every non-tensor field from the target)."""
    if program.golden is None and isinstance(extra, dict) and extra.get(GOLDEN_KEY):
        return dataclasses.replace(program,
                                   golden=GoldenRecord.from_json(extra[GOLDEN_KEY]))
    return program


class ProgramIntegrityError(ValueError):
    """A restored program failed static verification — a corrupt, truncated
    or stale checkpoint that must not reach ``execute``.  Carries the ERROR
    findings as ``.findings``."""

    def __init__(self, message: str, findings=()):
        super().__init__(message)
        self.findings = tuple(findings)


def _check_verified(program: BinArrayProgram, where: str) -> None:
    from repro_torch.analysis.verify import verify_program

    errors = [f for f in verify_program(program) if f.severity == "ERROR"]
    if errors:
        raise ProgramIntegrityError(
            f"restored program ({where}) failed verification with "
            f"{len(errors)} ERROR finding(s):\n  " + "\n  ".join(map(str, errors)),
            findings=errors)


def load_program(manager, step: int, like: BinArrayProgram, *,
                 verify: bool = True) -> BinArrayProgram:
    """Restore a program saved with :func:`save_program` (by this package
    or by the JAX package's ``save_program``) onto ``like``'s device.
    ``like`` supplies the structure, plans and stats: :func:`abstract_program`
    with the same arch/quant/input_shape, or any same-shaped program.

    By default the restored program is verified (``verify_program``) and
    any ERROR finding raises :class:`ProgramIntegrityError`.  A program the
    JAX package saved carries no port golden record: attach one with
    ``dataclasses.replace(program, golden=compute_golden(program))``.
    """
    restored, extra = manager.restore(step, {"program": like})
    program = _attach_golden(restored["program"], extra)
    if verify:
        _check_verified(program, f"step {step}")
    return program


def load_latest_good(manager, like: BinArrayProgram, *, verify: bool = True,
                     selftest: bool = True):
    """Restore the newest checkpoint step whose program passes every gate.

    The walk runs newest-first; a step failing digest verification, static
    verification (``verify``) or the golden self-test (``selftest``, when
    the step carries a port record made on the device type it is restored
    onto) is quarantined with its reason and the walk goes on.  Returns
    ``(step, program)``; raises ``NoGoodCheckpoint`` when every step is bad.
    """
    def validate(restored, extra):
        program = _attach_golden(restored["program"], extra)
        if verify:
            _check_verified(program, "latest good")
        if selftest and program.golden is not None \
                and program.golden.device == program.device.type:
            from repro_torch.deploy.selftest import self_test

            self_test(program)

    step, restored, extra = manager.restore_latest_good(
        {"program": like}, validate=validate)
    return step, _attach_golden(restored["program"], extra)
