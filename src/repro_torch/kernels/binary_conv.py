"""Per-tap weight layout and launcher of the CUDA fused binary conv
(``csrc/binary_conv.cu``).

Replaces ``src/repro/kernels/binary_conv.py`` ``binary_conv2d_pallas``: an
implicit-GEMM conv over pre-padded NHWC input with the bias + max-pool +
ReLU epilogue before the only write.

``B_tap_packed [M, kh*kw, ceil(C/8), D]`` uint8 holds, in byte
``(m, t, c8, d)``, channels ``8*c8 .. 8*c8+7`` of filter d's level-m ±1
weights at tap ``t = i*kw + j``, LSB-first (bit j set iff channel 8*c8 + j
is +1).  Each tap's C-slice is padded to its own byte with +1 bits, which
the kernel and the plain version never read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import binarize as bz
from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
_KC = 32          # reduction rows staged per step in the kernel (csrc/binary_conv.cu)
_SHMEM_LIMIT = 48 * 1024


def pack_taps(B: torch.Tensor, kh: int, kw: int, C: int) -> torch.Tensor:
    """±1 int8 [M, kh*kw*C, D] -> per-tap packed [M, kh*kw, ceil(C/8), D]."""
    M, K, D = B.shape
    Bt = bz.pad_rows_to_byte(B.reshape(M * kh * kw, C, D), dim=1)
    return bz.pack_bits(Bt).reshape(M, kh * kw, -1, D)


def unpack_taps(packed: torch.Tensor, C: int) -> torch.Tensor:
    """Per-tap packed [M, T, ceil(C/8), D] -> ±1 int8 [M, T*C, D]."""
    M, T, C8, D = packed.shape
    B = bz.unpack_bits(packed.reshape(M * T, C8, D), C8 * 8)
    return B.reshape(M, T, C8 * 8, D)[:, :, :C, :].reshape(M, T * C, D)


def shared_bytes(plan: tuple[int, int]) -> int:
    rows, cols = plan
    return 8 * (rows + _KC) + 4 * (rows * (_KC + 1) + _KC * cols) + 8 * _KC


def check_plan(plan: tuple[int, int]) -> None:
    rows, cols = plan
    if rows < 4 or cols < 4 or rows % 4 or cols % 4 or not (
            _KC <= (rows // 4) * (cols // 4) <= 1024):
        raise ValueError(f"conv plan {plan}: rows and cols must be multiples "
                         f"of 4 with {_KC} <= (rows/4)*(cols/4) <= 1024 threads")
    if shared_bytes(plan) > _SHMEM_LIMIT:
        raise ValueError(f"conv plan {plan} needs {shared_bytes(plan)} bytes "
                         f"of shared memory (> {_SHMEM_LIMIT})")


def launch(x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor,
           bias: torch.Tensor, *, kh: int, kw: int, stride: int, pool: int,
           m_active: int, relu: bool, plan: tuple[int, int]) -> torch.Tensor:
    """Pre-padded x [B, Hp, Wp, C] f32 -> [B, U/pool, V/pool, D] f32 on x's
    card, U = (Hp-kh)//stride + 1 and V likewise; every argument checked."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"x must be [B, Hp, Wp, C], got {tuple(x.shape)}")
    B, Hp, Wp, C = x.shape
    M, T, C8, D = B_tap_packed.shape
    G = alpha.shape[1]
    _build.require(x, "x", torch.float32, (B, Hp, Wp, C))
    _build.require(B_tap_packed, "B_tap_packed", torch.uint8,
                   (M, kh * kw, -(-C // 8), D), x.device)
    _build.require(alpha, "alpha", torch.float32, (M, G, D), x.device)
    _build.require(bias, "bias", torch.float32, (D,), x.device)
    K = kh * kw * C
    if K % G:
        raise ValueError(f"alpha's {G} groups do not divide K={K}")
    if not 1 <= m_active <= M:
        raise ValueError(f"m_active={m_active} outside 1..{M}")
    U = (Hp - kh) // stride + 1
    V = (Wp - kw) // stride + 1
    if U < 1 or V < 1 or U % pool or V % pool:
        raise ValueError(f"conv output {U}x{V} not positive or not divisible "
                         f"by pool {pool} (downsampling only, paper §III-B)")
    check_plan(plan)
    out = torch.empty((B, U // pool, V // pool, D), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("binary_conv", _ARGTYPES, x.data_ptr(), B_tap_packed.data_ptr(),
                      alpha.data_ptr(), bias.data_ptr(), out.data_ptr(),
                      B, Hp, Wp, C, D, kh, kw, stride, pool, U // pool, V // pool,
                      G, K // G, m_active, int(relu), plan[0], plan[1],
                      torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return out
