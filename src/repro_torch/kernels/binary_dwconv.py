"""Channel-packed weight layout and launcher of the CUDA fused binary
depth-wise conv (``csrc/binary_dwconv.cu``).

Replaces ``src/repro/kernels/binary_dwconv.py`` ``binary_dwconv2d_pallas``:
levels folded into effective taps ``eff[t, c] = sum_m alpha[m, c] B[m, t, c]``,
channel-wise strided tap accumulation, bias + ReLU, one write.

``B_tap_packed [M, kh*kw, ceil(C/8)]`` uint8 holds, in byte ``(m, t, c8)``,
channels ``8*c8 .. 8*c8+7`` of the level-m ±1 weights at tap ``t``,
LSB-first; the C axis is padded to a byte with +1 bits, never read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import binarize as bz
from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_TILES = (1, 2, 4, 8)        # outputs per thread, as 1x1, 1x2, 2x2, 2x4 (rows x columns)
_COLS = (32, 64, 128, 256)   # channels per block; the block has at most 256 threads


def pack_dw_taps(B: torch.Tensor) -> torch.Tensor:
    """±1 int8 [M, kh*kw, C] -> channel-packed [M, kh*kw, ceil(C/8)] uint8."""
    M, T, C = B.shape
    Bp = bz.pad_rows_to_byte(B, dim=2)
    return bz.pack_bits(Bp.reshape(M * T, Bp.shape[2], 1)).reshape(M, T, -1)


def unpack_dw_taps(packed: torch.Tensor, C: int) -> torch.Tensor:
    """uint8 [M, kh*kw, ceil(C/8)] -> ±1 int8 [M, kh*kw, C] (inverse)."""
    M, T, c8 = packed.shape
    B = bz.unpack_bits(packed.reshape(M * T, c8, 1), c8 * 8)
    return B.reshape(M, T, c8 * 8)[:, :, :C]


def check_plan(plan: tuple[int, int]) -> None:
    tile, cols = plan
    if tile not in _TILES or cols not in _COLS:
        raise ValueError(f"dwconv plan {plan}: outputs per thread must be one of "
                         f"{_TILES} and channels per block one of {_COLS}")


def launch(x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor,
           bias: torch.Tensor, *, kh: int, kw: int, stride: int, pads: tuple[int, int],
           out_hw: tuple[int, int], m_active: int, relu: bool,
           plan: tuple[int, int]) -> torch.Tensor:
    """Unpadded x [B, H, W, C] f32 -> [B, U, V, C] f32 on x's card, for
    ``pads`` = (pad_top, pad_left) and ``out_hw`` = (U, V) (from
    ``core.binconv.conv_geometry``); taps outside x read a zero, as from a
    padded copy.  Every argument checked."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    M = B_tap_packed.shape[0]
    _build.require(x, "x", torch.float32, (B, H, W, C))
    _build.require(B_tap_packed, "B_tap_packed", torch.uint8,
                   (M, kh * kw, -(-C // 8)), x.device)
    _build.require(alpha, "alpha", torch.float32, (M, C), x.device)
    _build.require(bias, "bias", torch.float32, (C,), x.device)
    if (kh, kw) != (3, 3) or stride not in (1, 2):
        raise ValueError(f"the dwconv kernel takes 3x3 filters at stride 1 or 2, "
                         f"got {kh}x{kw} at stride {stride}")
    if not 1 <= m_active <= M:
        raise ValueError(f"m_active={m_active} outside 1..{M}")
    (pt, pl), (U, V) = pads, out_hw
    if U < 1 or V < 1:
        raise ValueError(f"dwconv output {U}x{V} is empty")
    if not (0 <= pt < kh and 0 <= pl < kw and (U - 1) * stride - pt < H
            and (V - 1) * stride - pl < W):
        raise ValueError(f"pads {pads} and output {U}x{V} do not fit a {H}x{W} "
                         f"input at stride {stride}")
    check_plan(plan)
    out = torch.empty((B, U, V, C), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("binary_dwconv", _ARGTYPES, x.data_ptr(), B_tap_packed.data_ptr(),
                      alpha.data_ptr(), bias.data_ptr(), out.data_ptr(),
                      B, H, W, C, kh, kw, stride, U, V, pt, pl, m_active, int(relu),
                      plan[0], plan[1], torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return out
