"""Launcher of the CUDA binary matmul (``csrc/binary_matmul.cu``).

Replaces ``src/repro/kernels/binary_matmul.py`` ``binary_matmul_pallas``:
``y[T, N] = sum_{m<m_active} alpha_m ⊙ (x @ B_m)`` over LSB-first packed
``B_packed [M, ceil(K/8), N]`` with grouped ``alpha [M, G, N]``, x read in
fp32 or bf16 (``X_DTYPES``: the TPU kernel takes x in the caller's dtype and
casts it to fp32 in its body; this one widens each bf16 element as it stages
it, two per 32-bit load where K is even and x 4-byte aligned, so a bf16 x
gives the bits of ``x.float()``), the sums and y fp32.  The
plain version is ``kernels/ref.py binary_matmul_ref``; ``kernels/ops.py``
picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
X_DTYPES = (torch.float32, torch.bfloat16)   # the x the kernel reads (its x_bf16 flag)


KSPLIT = 8             # reduction chunks of the kernel (csrc/binary_matmul.cu)
MAX_LEVELS = 4         # the kernel is built for m_active 1..4
_ROWS = (1, 2, 4, 8)   # output rows per thread (a register tile)
_COLS = (32, 64)       # output columns per block; the block has cols x 8 threads


def k_chunks(K: int) -> list[tuple[int, int]]:
    """The kernel's split of the reduction rows ``[0, K)`` into ``KSPLIT``
    chunks ``[k0, k1)`` on byte rows; the bounds depend on K alone, so every
    tile plan sums each output in the same order (k in order inside a
    chunk, then the chunks' sums in chunk order)."""
    K8 = -(-K // 8)
    return [(8 * (c * K8 // KSPLIT), min(K, 8 * ((c + 1) * K8 // KSPLIT)))
            for c in range(KSPLIT)]


def check_plan(plan: tuple[int, int]) -> None:
    rows, cols = plan
    if rows not in _ROWS or cols not in _COLS:
        raise ValueError(f"matmul plan {plan}: rows per thread must be one of "
                         f"{_ROWS} and columns per block one of {_COLS}")


def launch(x: torch.Tensor, B_packed: torch.Tensor, alpha: torch.Tensor, *,
           K: int, group_size: int, m_active: int,
           plan: tuple[int, int]) -> torch.Tensor:
    """x [T, K] f32 or bf16 -> y [T, N] f32 on x's card; every argument
    checked."""
    global launches
    T = x.shape[0]
    M, K8, N = B_packed.shape
    G = alpha.shape[1]
    _build.require(x, "x", X_DTYPES, (T, K))
    _build.require(B_packed, "B_packed", torch.uint8, (M, -(-K // 8), N), x.device)
    _build.require(alpha, "alpha", torch.float32, (M, G, N), x.device)
    if G * group_size != K:
        raise ValueError(f"alpha has {G} groups of {group_size}, K={K}")
    if not 1 <= m_active <= min(M, MAX_LEVELS):
        raise ValueError(f"m_active={m_active} outside 1..{min(M, MAX_LEVELS)} (M={M}; "
                         f"the kernel sums at most {MAX_LEVELS} levels)")
    check_plan(plan)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    if T == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("binary_matmul", _ARGTYPES, x.data_ptr(), B_packed.data_ptr(),
                      alpha.data_ptr(), out.data_ptr(), T, K, N, G, group_size,
                      m_active, plan[0], plan[1], int(x.dtype == torch.bfloat16),
                      torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return out
