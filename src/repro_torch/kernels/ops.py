"""The kernel wrappers the deploy executor calls (port of ``repro/kernels/ops.py``).

Each wrapper clamps ``m_active`` to ``min(m_active or M, M)`` and resolves
SAME padding (so the kernels only see pre-padded NHWC input), then routes by
the tensor's device: a CUDA tensor goes to the CUDA kernel, a CPU tensor to
the plain PyTorch version in ``kernels/ref.py``; anything else raises.
There is no fallback from the kernel to the plain version.

Tile plans are ``(rows, cols)`` output tiles per thread block.  The pick
functions below choose one from the output shape and bump
``plan_pick_count()``; the deploy compiler calls them once per instruction
and freezes the result, so ``execute`` makes no pick.
"""
from __future__ import annotations

import torch

from repro_torch.core.binconv import pad_nhwc
from repro_torch.kernels import binary_conv as bck
from repro_torch.kernels import binary_dwconv as bdw
from repro_torch.kernels import binary_matmul as bmk
from repro_torch.kernels import ref as kref

_KERNELS = {"binary_conv": bck, "binary_dwconv": bdw, "binary_matmul": bmk}
_plan_picks = 0
_SMS = 132        # streaming multiprocessors of an H100 SXM


def plan_pick_count() -> int:
    """Process-wide count of tile-plan picks (any kernel)."""
    return _plan_picks


def reset_plan_pick_count() -> None:
    global _plan_picks
    _plan_picks = 0


def _note_pick() -> None:
    global _plan_picks
    _plan_picks += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches per CUDA kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_matmul_plan(T: int, N: int) -> tuple[int, int]:
    """(rows, cols) for a [T, N] output, one thread per output: a warp's
    width of columns, and 4 rows per block unless 8 still leaves two blocks
    per SM."""
    _note_pick()
    rows = 8 if _cdiv(T, 8) * _cdiv(N, 32) >= 2 * _SMS else 4
    return rows, 32


def pick_conv_plan(P: int, D: int) -> tuple[int, int]:
    """(rows, cols) for ``P`` pooled pixels x ``D`` channels: 256-thread
    blocks whose channel width fits D (32 / 64 / 128), halving the pixel
    rows while that leaves fewer blocks than SMs."""
    _note_pick()
    cols = 32 if D <= 32 else 64 if (D <= 64 or P >= 2048) else 128
    rows = 4096 // cols
    while rows > 16 and _cdiv(P, rows) * _cdiv(D, cols) < _SMS:
        rows //= 2
    return rows, cols


def pick_dwconv_plan(P: int, C: int) -> tuple[int, int]:
    """(rows, cols) for ``P`` pixels x ``C`` channels: a channel width that
    fits C, and 4 pixels per thread of the 256-thread block, so that many
    short blocks, not a few long ones, keep the loads in flight."""
    _note_pick()
    cols = 32 if C <= 32 else 64 if C <= 64 else 128
    return 4 * (256 // cols), cols


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}: expected cuda or cpu")


def binary_matmul(x: torch.Tensor, B_packed: torch.Tensor, alpha: torch.Tensor, *,
                  K: int, group_size: int, m_active: int | None = None,
                  plan: tuple[int, int] | None = None) -> torch.Tensor:
    """y[..., N] = sum_{m<m_active} alpha_m ⊙ (x[..., K] @ B_m), fp32."""
    M, _, N = B_packed.shape
    m = min(m_active or M, M)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if not _on_card(x):
        y = kref.binary_matmul_ref(x2, B_packed, alpha, K=K, group_size=group_size,
                                   m_active=m)
    else:
        x2 = x2.to(torch.float32).contiguous()
        y = bmk.launch(x2, B_packed, alpha, K=K, group_size=group_size, m_active=m,
                       plan=plan or pick_matmul_plan(x2.shape[0], N))
    return y.reshape(*lead, N)


def binary_conv2d(x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor,
                  bias: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                  padding: str = "VALID", pool: int = 1, m_active: int | None = None,
                  relu: bool = True, plan: tuple[int, int] | None = None) -> torch.Tensor:
    """Fused binary conv + bias + max-pool + ReLU: x [B, H, W, C] ->
    [B, U//pool, V//pool, D] fp32."""
    m = min(m_active or B_tap_packed.shape[0], B_tap_packed.shape[0])
    if not _on_card(x):
        return kref.fused_binary_conv_relu_pool_ref(
            x, B_tap_packed, alpha, kh=kh, kw=kw, stride=stride, padding=padding,
            pool=pool, m_active=m, bias=bias, relu=relu)
    xp = pad_nhwc(x.to(torch.float32), kh, kw, stride, padding).contiguous()
    if plan is None:
        B, Hp, Wp, _ = xp.shape
        U, V = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
        plan = pick_conv_plan(B * (U // pool) * (V // pool), B_tap_packed.shape[-1])
    return bck.launch(xp, B_tap_packed, alpha, bias, kh=kh, kw=kw, stride=stride,
                      pool=pool, m_active=m, relu=relu, plan=plan)


def binary_dwconv2d(x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor,
                    bias: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                    padding: str = "SAME", m_active: int | None = None,
                    relu: bool = True, plan: tuple[int, int] | None = None) -> torch.Tensor:
    """Fused binary depth-wise conv + bias + ReLU: x [B, H, W, C] -> [B, U, V, C] fp32."""
    m = min(m_active or B_tap_packed.shape[0], B_tap_packed.shape[0])
    if not _on_card(x):
        return kref.binary_dwconv_relu_ref(
            x, B_tap_packed, alpha, kh=kh, kw=kw, stride=stride, padding=padding,
            m_active=m, bias=bias, relu=relu)
    xp = pad_nhwc(x.to(torch.float32), kh, kw, stride, padding).contiguous()
    if plan is None:
        B, Hp, Wp, C = xp.shape
        U, V = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
        plan = pick_dwconv_plan(B * U * V, C)
    return bdw.launch(xp, B_tap_packed, alpha, bias, kh=kh, kw=kw, stride=stride,
                      m_active=m, relu=relu, plan=plan)
