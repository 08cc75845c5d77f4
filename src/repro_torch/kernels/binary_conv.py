"""Per-tap weight layout and launcher of the CUDA fused binary conv
(``csrc/binary_conv.cu``).

Replaces ``src/repro/kernels/binary_conv.py`` ``binary_conv2d_pallas``: an
implicit-GEMM conv over unpadded NHWC input (the kernel masks the SAME
border) with the bias + max-pool + ReLU epilogue before the only write.

``B_tap_packed [M, kh*kw, ceil(C/8), D]`` uint8 holds, in byte
``(m, t, c8, d)``, channels ``8*c8 .. 8*c8+7`` of filter d's level-m ±1
weights at tap ``t = i*kw + j``, LSB-first (bit j set iff channel 8*c8 + j
is +1).  Each tap's C-slice is padded to its own byte with +1 bits, which
the kernel and the plain version never read.

The kernel's GEMM rows are unpooled conv outputs, pooled pixel major and
window offset minor, a block holding ``rows // pool**2`` whole windows;
``gemm_rows`` mirrors that order and ``shared_bytes`` its shared memory,
so the CPU tests can hold both to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import binarize as bz
from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 21 + [ctypes.c_void_p]
ROWS = (64, 96, 128)    # GEMM rows (unpooled outputs) per block
COLS = (32, 64, 128)    # output channels per block; a thread holds a (rows/16) x (cols/16) tile
K_CHUNK = 32            # reduction rows staged per step (csrc/binary_conv.cu BK)
STAGES = 3              # chunks in the cp.async ring
MAX_LEVELS = 4          # the kernel folds m_active 1..4 levels
THREADS = 256           # per block; each folds K_CHUNK * cols / THREADS weights a chunk
SHMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use


def pack_taps(B: torch.Tensor, kh: int, kw: int, C: int) -> torch.Tensor:
    """±1 int8 [M, kh*kw*C, D] -> per-tap packed [M, kh*kw, ceil(C/8), D]."""
    M, K, D = B.shape
    Bt = bz.pad_rows_to_byte(B.reshape(M * kh * kw, C, D), dim=1)
    return bz.pack_bits(Bt).reshape(M, kh * kw, -1, D)


def repack_taps(B_packed: torch.Tensor, kh: int, kw: int, C: int) -> torch.Tensor:
    """Flat [M, ceil(K/8), D] uint8 -> per-tap [M, kh*kw, ceil(C/8), D] uint8
    (K = kh*kw*C row-major over (tap_i, tap_j, c)): the one-time layout
    upgrade of a packed tree that carries only the flat stream."""
    B = bz.unpack_bits(B_packed, B_packed.shape[1] * 8)[:, :kh * kw * C, :]
    return pack_taps(B, kh, kw, C)


def unpack_taps(packed: torch.Tensor, C: int) -> torch.Tensor:
    """Per-tap packed [M, T, ceil(C/8), D] -> ±1 int8 [M, T*C, D]."""
    M, T, C8, D = packed.shape
    B = bz.unpack_bits(packed.reshape(M * T, C8, D), C8 * 8)
    return B.reshape(M, T, C8 * 8, D)[:, :, :C, :].reshape(M, T * C, D)


def shared_bytes(plan: tuple[int, int], levels: int = MAX_LEVELS) -> int:
    """Dynamic shared memory of one block (``csrc/binary_conv.cu``
    ``shared_bytes``): a ring of ``STAGES`` stages of the x tile and the
    packed bytes of ``levels`` levels, two buffers of folded weights, and
    the per-row offsets; the epilogue reuses the ring."""
    rows, cols = plan
    stage = 4 * K_CHUNK * (rows + 4) + -(-levels * K_CHUNK * (cols + 4) // 16) * 16
    ring = STAGES * stage + 2 * 4 * K_CHUNK * (cols + 4)
    return max(ring, 4 * rows * (cols + 4)) + 16 * rows


def check_plan(plan: tuple[int, int], pool: int = 1) -> None:
    rows, cols = plan
    if rows not in ROWS or cols not in COLS:
        raise ValueError(f"conv plan {plan}: rows per block must be one of {ROWS} "
                         f"and channels per block one of {COLS}")
    if pool * pool > rows:
        raise ValueError(f"conv plan {plan}: a {pool}x{pool} pool window does not "
                         f"fit in {rows} rows")
    if shared_bytes(plan) > SHMEM_LIMIT:
        raise ValueError(f"conv plan {plan} needs {shared_bytes(plan)} bytes "
                         f"of shared memory (> {SHMEM_LIMIT})")


def gemm_rows(B: int, Uo: int, Vo: int, pool: int, rows: int) -> torch.Tensor:
    """The kernel's GEMM row order: ``[blocks, rows, 3]`` int64 holding the
    unpooled output ``(b, u, v)`` of each row of each block, ``-1`` for
    rows past the last whole window; row ``r`` of block ``x`` is offset
    ``r % pool**2`` of pooled pixel ``x * (rows // pool**2) + r // pool**2``."""
    pp = pool * pool
    nwin = rows // pp
    Q = B * Uo * Vo
    blocks = -(-Q // nwin)
    r = torch.arange(rows)
    q = torch.arange(blocks)[:, None] * nwin + r // pp
    valid = (r < nwin * pp) & (q < Q)
    b, rem = q // (Uo * Vo), q % (Uo * Vo)
    w = r % pp
    u = (rem // Vo) * pool + w // pool
    v = (rem % Vo) * pool + w % pool
    out = torch.stack([b, u, v], dim=-1)
    return torch.where(valid[..., None], out, torch.full_like(out, -1))


def launch(x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor,
           bias: torch.Tensor, *, kh: int, kw: int, stride: int, pads: tuple[int, int],
           out_hw: tuple[int, int], pool: int, m_active: int, relu: bool,
           plan: tuple[int, int], gather: bool = False) -> torch.Tensor:
    """Unpadded x [B, H, W, C] f32 -> [B, U/pool, V/pool, D] f32 on x's card,
    for ``pads`` = (pad_top, pad_left) and ``out_hw`` = (U, V) (from
    ``core.binconv.conv_geometry``); taps outside x read a zero, as from a
    padded copy.  ``gather`` takes the kernel's general x path on a 1x1
    layer too (the two give the same bits).  Every argument checked."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    M, T, C8, D = B_tap_packed.shape
    G = alpha.shape[1]
    _build.require(x, "x", torch.float32, (B, H, W, C))
    _build.require(B_tap_packed, "B_tap_packed", torch.uint8,
                   (M, kh * kw, -(-C // 8), D), x.device)
    _build.require(alpha, "alpha", torch.float32, (M, G, D), x.device)
    _build.require(bias, "bias", torch.float32, (D,), x.device)
    K = kh * kw * C
    if K % G:
        raise ValueError(f"alpha's {G} groups do not divide K={K}")
    if not 1 <= m_active <= min(M, MAX_LEVELS):
        raise ValueError(f"m_active={m_active} outside 1..{min(M, MAX_LEVELS)} (M={M}; "
                         f"the kernel folds at most {MAX_LEVELS} levels)")
    (pt, pl), (U, V) = pads, out_hw
    if U < 1 or V < 1 or U % pool or V % pool:
        raise ValueError(f"conv output {U}x{V} not positive or not divisible "
                         f"by pool {pool} (downsampling only, paper §III-B)")
    if not (0 <= pt < kh and 0 <= pl < kw and (U - 1) * stride - pt < H
            and (V - 1) * stride - pl < W):
        raise ValueError(f"pads {pads} and output {U}x{V} do not fit a {H}x{W} "
                         f"input at stride {stride}")
    if B_tap_packed.data_ptr() % 4:
        raise ValueError("B_tap_packed must start on a 4-byte boundary")
    check_plan(plan, pool)
    out = torch.empty((B, U // pool, V // pool, D), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("binary_conv", _ARGTYPES, x.data_ptr(), B_tap_packed.data_ptr(),
                      alpha.data_ptr(), bias.data_ptr(), out.data_ptr(),
                      B, H, W, C, D, M, kh, kw, stride, pt, pl, pool, U // pool,
                      V // pool, G, K // G, m_active, int(relu), plan[0], plan[1],
                      int(gather), torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return out
