"""Fixed-point quantization emulation (paper §III-C), port of
``repro/core/quant.py``.

The FPGA datapath uses DW=8-bit fixed-point activations with a per-layer
binary-point position, MULW=28-bit accumulation inside the DSP cascade, and
round-to-nearest + saturation when quantizing PA outputs back to DW bits
before the AMU.  The port accumulates in fp32 (wider than 28-bit fixed
point) and provides the DW-bit activation quantizer, its straight-through
form for training, and the int8 pair for deployment.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

DW = 8        # activation data width (paper)
MULW = 28     # DSP accumulation width (paper; informational, the port sums in fp32)


class FixedPointSpec(NamedTuple):
    """Per-layer fixed-point format: DW total bits, ``frac`` fractional bits."""

    bits: int = DW
    frac: int = 4  # binary point position; layer-dependent in the paper


def quantize_fixed(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Round-to-nearest (ties to even), saturate: the QS block of the SA
    (paper Fig. 7) on fp values: scale by 2^frac, round, clip to
    [-2^(bits-1), 2^(bits-1)-1], rescale."""
    scale = 2.0 ** spec.frac
    lo, hi = -(2 ** (spec.bits - 1)), 2 ** (spec.bits - 1) - 1
    return torch.clamp(torch.round(x * scale), lo, hi) / scale


class _QuantizeFixedSTE(torch.autograd.Function):
    """Forward: the fixed-point quantizer; backward: identity to ``x``."""

    @staticmethod
    def forward(ctx, x, scale, lo, hi):
        return torch.clamp(torch.round(x * scale), lo, hi) / scale

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def quantize_fixed_ste(x: torch.Tensor, scale: float, lo: float, hi: float) -> torch.Tensor:
    """``clip(round(x * scale), lo, hi) / scale`` with a straight-through
    gradient (the JAX package's ``custom_vjp``)."""
    return _QuantizeFixedSTE.apply(x, scale, lo, hi)


def fake_quant_activation(x: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """STE-wrapped activation quantizer for QAT with the fixed-point datapath."""
    return quantize_fixed_ste(x, 2.0 ** spec.frac, float(-(2 ** (spec.bits - 1))),
                              float(2 ** (spec.bits - 1) - 1))


def choose_frac_bits(x_absmax: float, bits: int = DW) -> int:
    """Pick the binary-point position covering |x| <= x_absmax (per layer)."""
    if x_absmax <= 0:
        return bits - 1
    int_bits = max(0, math.ceil(math.log2(x_absmax + 1e-12)) + 1)  # sign incl.
    return max(0, bits - 1 - int_bits)


# --- int8 symmetric activation quant (deployment path) ---------------------

class Int8Quant(NamedTuple):
    values: torch.Tensor   # int8
    scale: torch.Tensor    # fp32 per-tensor (or per-row) scale


def quantize_int8(x: torch.Tensor, axis: int | None = None) -> Int8Quant:
    absmax = (torch.amax(torch.abs(x)) if axis is None
              else torch.amax(torch.abs(x), dim=axis, keepdim=True))
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return Int8Quant(values=q, scale=scale.to(torch.float32))


def dequantize_int8(q: Int8Quant) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scale
