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

Layers whose input channels do not fill a packed byte (C < 8: CNN-A's
conv1 and conv2, MobileNet's stem) take a second kernel of the same source,
a direct convolution (``binary_conv_kernel_direct``): a block stages its
input rows with their halo once and folds its channel slice's weights once
for all of K, and each thread holds ``DIRECT_COLS`` neighbouring outputs of
a row by ``td`` channels in registers.  ``direct_plan`` picks its tile
from the shape (``None`` where the GEMM path runs) and ``direct_blocks``
mirrors what each block stages and computes.  Both paths give the same
bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import binarize as bz
from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset_launch_counts(), both paths
direct_launches = 0   # of those, launches that took the direct path

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 21 + [ctypes.c_void_p]
_DIRECT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 25 + [ctypes.c_void_p]
ROWS = (64, 96, 128)    # GEMM rows (unpooled outputs) per block
COLS = (32, 64, 128)    # output channels per block; a thread holds a (rows/16) x (cols/16) tile
K_CHUNK = 32            # reduction rows staged per step (csrc/binary_conv.cu BK)
STAGES = 3              # chunks in the cp.async ring
MAX_LEVELS = 4          # the kernel folds m_active 1..4 levels
THREADS = 256           # per block; each folds K_CHUNK * cols / THREADS weights a chunk
SHMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may use
DIRECT_COLS = 6         # unpooled outputs per thread along a row, direct path
DIRECT_THREADS = 256    # most threads of a direct-path block
_SMS = 132              # streaming multiprocessors of an H100 SXM


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


class DirectPlan(NamedTuple):
    """The direct path's tile at one shape (``csrc/binary_conv.cu``
    ``binary_conv_direct_launch`` takes these numbers as they are).

    An *item* is one thread's work: ``rows`` unpooled output rows (a pool
    window's rows) by ``DIRECT_COLS`` unpooled columns (``nw`` whole
    windows) by ``td`` channels.  A block holds ``ni``
    images by ``bu`` item rows by all ``nt`` column tiles by ``ndg`` channel
    groups, and stages ``sh`` input rows of ``sw`` columns per image, each
    pixel padded to ``cp`` floats, plus the folded weights of its channel
    groups, ``[K][ndg][8]`` floats."""
    cp: int            # floats per staged pixel (channels padded for 16-byte loads)
    td: int            # output channels per thread
    rows: int          # unpooled rows per item: the pool
    nw: int            # pooled outputs per item along a row
    nt: int            # column tiles per item row
    item_rows: int     # item rows per image
    ndg: int           # channel groups per block
    nds: int           # channel slices (the grid's second axis)
    bu: int            # item rows per block
    nbands: int        # bands of item rows per image
    ni: int            # images per block
    sh: int            # staged input rows per image
    sw: int            # staged input columns
    threads: int
    blocks: int        # the grid's first axis: image groups x bands
    shared_bytes: int


def direct_shared_bytes(p: DirectPlan, K: int) -> int:
    """Dynamic shared memory of one direct-path block (``csrc/binary_conv.cu``
    ``direct_bytes``), from the tile's geometry: ``p.ni`` images of ``p.sh``
    staged rows by ``p.sw`` pixels of ``p.cp`` floats, and the folded
    weights of ``p.ndg`` channel groups, 8 floats each for every k < K."""
    return 4 * (p.ni * p.sh * p.sw * p.cp + K * p.ndg * 8)


@functools.lru_cache(maxsize=256)
def direct_plan(B: int, H: int, W: int, C: int, D: int, kh: int, kw: int, stride: int,
                pool: int, out_hw: tuple[int, int]) -> DirectPlan | None:
    """The direct path's tile for a conv over x [B, H, W, C] with output
    ``out_hw`` = (U, V), or ``None`` where the GEMM path runs: C >= 8, a
    pool window wider than a thread's ``DIRECT_COLS``, or no tile that fits
    ``SHMEM_LIMIT``.  Of the tiles that fit (half the limit where one does,
    so two blocks share an SM), the one with the fewest lane-FMAs plus
    staged elements over the grid, the grid counted as at least two blocks
    per SM (so a small batch is cut into bands of rows)."""
    U, V = out_hw
    if C >= 8 or pool > DIRECT_COLS:
        return None
    cp = 4 if C <= 4 else 8
    td = 8 if D % 8 == 0 else 5          # 8: each pixel's channels in whole 32-byte sectors
    rows = pool
    nw = DIRECT_COLS // pool
    nt = -(-(V // pool) // nw)
    item_rows = U // pool
    ndg_total = -(-D // td)
    K = kh * kw * C
    sw = ((nt - 1) * nw * pool + DIRECT_COLS - 1) * stride + kw
    best = None
    for ndg in sorted({-(-ndg_total // nds) for nds in range(1, ndg_total + 1)}):
        nds = -(-ndg_total // ndg)
        for bu in range(1, item_rows + 1):
            for ni in (1, 2, 4, 8):
                if ni > 1 and (bu < item_rows or ni > B):
                    continue
                items = ni * bu * nt * ndg
                threads = min(DIRECT_THREADS, -(-items // 32) * 32)
                nbands = -(-item_rows // bu)
                p = DirectPlan(cp=cp, td=td, rows=rows, nw=nw, nt=nt, item_rows=item_rows,
                               ndg=ndg, nds=nds, bu=bu, nbands=nbands, ni=ni,
                               sh=(bu * rows - 1) * stride + kh, sw=sw, threads=threads,
                               blocks=-(-B // ni) * nbands, shared_bytes=0)
                shared = direct_shared_bytes(p, K)
                if shared > SHMEM_LIMIT:
                    continue
                lanes = -(-items // threads) * threads
                per_block = (lanes * rows * DIRECT_COLS * td * K
                             + 8 * (ni * p.sh * sw * C + K * ndg * td))
                key = (shared > SHMEM_LIMIT // 2, max(p.blocks * nds, 2 * _SMS) * per_block,
                       shared)
                if best is None or key < best[0]:
                    best = (key, p._replace(shared_bytes=shared))
    return None if best is None else best[1]


def direct_blocks(p: DirectPlan, B: int, U: int, V: int, D: int, stride: int, pool: int,
                  pads: tuple[int, int]):
    """What each block of the direct path stages and computes, as the kernel
    walks it: yields ``(staged, items)`` per block, ``staged`` the first
    image, input row and input column of its staged region (``p.ni`` images
    by ``p.sh`` rows by ``p.sw`` columns; a cell outside the input is staged
    as zero) and ``items`` a list of ``(b, us, vs, ds)`` per thread item:
    its image, the unpooled rows and columns it computes and its channels
    (rows and columns past the output and channels past D left out)."""
    pt, pl = pads
    Uo, Vo = U // pool, V // pool
    for bx in range(p.blocks):
        ig, band = divmod(bx, p.nbands)
        for by in range(p.nds):
            b0, r0 = ig * p.ni, band * p.bu * p.rows
            staged = (b0, r0 * stride - pt, -pl)
            items = []
            for e in range(p.ni * p.bu * p.nt * p.ndg):
                dg, t = e % p.ndg, e // p.ndg
                ct, t = t % p.nt, t // p.nt
                ir, im = t % p.bu, t // p.bu
                b, u0 = b0 + im, r0 + ir * p.rows
                if b >= B or band * p.bu + ir >= p.item_rows:
                    continue
                us = [u for u in range(u0, u0 + p.rows) if u < U]
                vs = [v for v in range(ct * p.nw * pool, ct * p.nw * pool + p.nw * pool)
                      if v < Vo * pool]
                d0 = (by * p.ndg + dg) * p.td
                ds = [d for d in range(d0, d0 + p.td) if d < D]
                if vs and ds:
                    items.append((b, us, vs, ds))
            yield staged, items


def launch(x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor,
           bias: torch.Tensor, *, kh: int, kw: int, stride: int, pads: tuple[int, int],
           out_hw: tuple[int, int], pool: int, m_active: int, relu: bool,
           plan: tuple[int, int], gather: bool = False, gemm: bool = False) -> torch.Tensor:
    """Unpadded x [B, H, W, C] f32 -> [B, U/pool, V/pool, D] f32 on x's card,
    for ``pads`` = (pad_top, pad_left) and ``out_hw`` = (U, V) (from
    ``core.binconv.conv_geometry``); taps outside x read a zero, as from a
    padded copy.  Where ``direct_plan`` gives a tile (C < 8) the direct
    kernel runs and ``plan`` is not read; ``gemm`` takes the GEMM kernel
    there too, and ``gather`` its general x path on a 1x1 layer (each pair
    gives the same bits).  Every argument checked."""
    global launches, direct_launches
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
    direct = None if gemm else direct_plan(B, H, W, C, D, kh, kw, stride, pool, (U, V))
    common = (x.data_ptr(), B_tap_packed.data_ptr(), alpha.data_ptr(), bias.data_ptr(),
              out.data_ptr(), B, H, W, C, D, M, kh, kw, stride, pt, pl, pool, U // pool,
              V // pool, G, K // G, m_active, int(relu))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if direct is None:
            _build.launch("binary_conv", _ARGTYPES, *common,
                          plan[0], plan[1], int(gather), stream)
        else:
            _build.launch("binary_conv", _DIRECT_ARGTYPES, *common, direct.td, direct.nt,
                          direct.bu, direct.ni, direct.ndg, direct.nds, direct.nbands,
                          stream, entry="binary_conv_direct_launch")
            direct_launches += 1
    launches += 1
    return out
