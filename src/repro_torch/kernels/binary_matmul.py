"""Launcher of the CUDA binary matmul (``csrc/binary_matmul.cu``).

Replaces ``src/repro/kernels/binary_matmul.py`` ``binary_matmul_pallas``:
``y[T, N] = sum_{m<m_active} alpha_m ⊙ (x @ B_m)`` over LSB-first packed
``B_packed [M, ceil(K/8), N]`` with grouped ``alpha [M, G, N]``.  The plain
version is ``kernels/ref.py binary_matmul_ref``; ``kernels/ops.py`` picks
between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def check_plan(plan: tuple[int, int]) -> None:
    rows, cols = plan
    if rows < 1 or cols < 1 or rows * cols > 1024:
        raise ValueError(f"matmul plan {plan}: one thread per output, so "
                         "rows * cols must be 1..1024")


def launch(x: torch.Tensor, B_packed: torch.Tensor, alpha: torch.Tensor, *,
           K: int, group_size: int, m_active: int,
           plan: tuple[int, int]) -> torch.Tensor:
    """x [T, K] f32 -> y [T, N] f32 on x's card; every argument checked."""
    global launches
    T = x.shape[0]
    M, K8, N = B_packed.shape
    G = alpha.shape[1]
    _build.require(x, "x", torch.float32, (T, K))
    _build.require(B_packed, "B_packed", torch.uint8, (M, -(-K // 8), N), x.device)
    _build.require(alpha, "alpha", torch.float32, (M, G, N), x.device)
    if G * group_size != K:
        raise ValueError(f"alpha has {G} groups of {group_size}, K={K}")
    if not 1 <= m_active <= M:
        raise ValueError(f"m_active={m_active} outside 1..{M}")
    check_plan(plan)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    if T == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("binary_matmul", _ARGTYPES, x.data_ptr(), B_packed.data_ptr(),
                      alpha.data_ptr(), out.data_ptr(), T, K, N, G, group_size,
                      m_active, plan[0], plan[1],
                      torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return out
