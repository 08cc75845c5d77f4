"""compile(): layer params + arch -> BinArrayProgram (paper §IV).

Port of ``repro/deploy/compiler.py`` ``compile``.  Everything static is
done once, here:

  1. **Pack** — fp trees are binarized (Algorithm 2) into the kernels'
     packed layouts; packed trees are reused as they are.
  2. **Plan** — one Hopper tile plan per instruction, picked for the
     compile-time ``input_shape`` by ``kernels/ops.py``'s pick functions
     (each pick bumps ``plan_pick_count()``) and frozen into the
     instruction, so ``execute`` picks nothing.
  3. **Account** — shapes, MACs and packed weight bytes in ``LayerStats``.

There is no golden record, verifier or save/load in the port yet.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import binconv
from repro_torch.core import binlinear as bl
from repro_torch.core.binlinear import QuantConfig
from repro_torch.deploy.program import (BinArrayProgram, ConvInstr, DWConvInstr,
                                        LayerStats, LinearInstr, TilePlan)
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
    if "B_tap_packed" not in p:
        if "B_packed" in p:
            raise ValueError(f"{spec.name}: packed conv tree without B_tap_packed "
                             "(flat-only trees are not supported by the port)")
        p = binconv.binarize_conv_params(p, quant)
    B, H, W, C = shape
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
            device="cuda") -> BinArrayProgram:
    """Compile a network into a :class:`BinArrayProgram` on ``device``.

    params:      fp tree (binarized here with ``quant``) or a packed tree
                 (``B_tap_packed``/``B_packed``, ``alpha``, ``b``), reused as
                 it is; both come from ``models/cnn.py`` or ``convert.py``.
    arch:        "cnn_a" | "mobilenet" or an explicit LayerSpec sequence.
    input_shape: (B, H, W, C) the tile plans are picked for.
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
    return BinArrayProgram(instrs=tuple(instrs),
                           arch=arch if isinstance(arch, str) else "custom",
                           input_shape=tuple(int(d) for d in input_shape))
