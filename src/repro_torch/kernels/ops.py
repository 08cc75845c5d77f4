"""The kernel wrappers the deploy executor calls (port of ``repro/kernels/ops.py``).

Each wrapper clamps ``m_active`` to ``min(m_active or M, M)`` and resolves
SAME padding into the low-side pads and the output size (both conv kernels
take the unpadded input and mask their border taps), then routes by the
tensor's device: a CUDA tensor goes to the CUDA kernel, a CPU tensor to the plain
PyTorch version in ``kernels/ref.py``; anything else raises.  There is no
fallback from the kernel to the plain version.

Tile plans are ``(rows, cols)`` pairs, read per kernel as each pick
function says.  The pick functions below choose one from the layer's shape
and bump ``plan_pick_count()``; the deploy compiler calls them once per
instruction and freezes the result, so ``execute`` makes no pick.
"""
from __future__ import annotations

import torch

from repro_torch.core.binconv import conv_geometry
from repro_torch.kernels import binary_conv as bck
from repro_torch.kernels import binary_dwconv as bdw
from repro_torch.kernels import binary_matmul as bmk
from repro_torch.kernels import ref as kref

_KERNELS = {"binary_conv": bck, "binary_dwconv": bdw, "binary_matmul": bmk}
_plan_picks = 0
_SMS = 132        # streaming multiprocessors of an H100 SXM
# the active cost counters (``launch/cost_analysis.CostCounter`` adds itself
# on entry and removes itself on exit); each gets every ``binary_matmul`` call
reporters: list = []


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
    bck.direct_launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_matmul_plan(T: int, N: int) -> tuple[int, int]:
    """(rows, cols) for a [T, N] output: ``rows`` output rows per thread
    (a register tile sharing each folded weight) and ``cols`` output
    columns per block, one warp wide; the most rows that still leave one
    block for every two SMs (the rule ``tools/torch_plan_sweep.py`` found
    fastest at CNN-A's and MobileNet's linear shapes)."""
    _note_pick()
    for rows in (8, 4, 2):
        if _cdiv(T, rows) * _cdiv(N, 32) >= _SMS // 2:
            return rows, 32
    return 1, 32


def conv_blocks(P: int, D: int, pool: int, plan: tuple[int, int]) -> int:
    """Blocks the conv kernel launches for ``P`` unpooled output rows: each
    holds ``rows // pool**2`` whole pool windows by ``cols`` channels."""
    rows, cols = plan
    pp = pool * pool
    return _cdiv(P // pp, rows // pp) * _cdiv(D, cols)


def pick_conv_plan(P: int, D: int, pool: int = 1) -> tuple[int, int]:
    """(rows, cols) for ``P`` unpooled conv outputs x ``D`` channels, the
    rule ``tools/torch_plan_sweep.py`` found fastest at every conv shape of
    CNN-A (batch 64) and MobileNetV1-224 (batch 16): the channel width that
    fits D (32 / 64 / 128; 64 where it pads D less than 128 does), 96 rows
    with 128 channels unpooled (one block per SM at the 14 x 14 layers),
    else 128 rows; and 128 x 64 where 96 x 128 would leave a quarter of
    the SMs idle."""
    _note_pick()
    cols = 32 if D <= 32 else 64 if D <= 64 else 128
    if D > 128 and -D % 64 < -D % 128:
        cols = 64
    if cols == 128 and pool == 1:
        if conv_blocks(P, D, pool, (96, 128)) >= 3 * _SMS // 4:
            return 96, 128
        return 128, 64
    return 128, cols


def pick_dwconv_plan(C: int) -> tuple[int, int]:
    """(tile, cols) for a depth-wise layer over ``C`` channels: 8 outputs
    per thread as a 2x4 tile (24 loads for 8 outputs at stride 1, one level
    fold per 8 outputs), the tile ``tools/torch_plan_sweep.py`` found
    fastest at every MobileNet depth-wise shape, and a channel width per
    block that fits C."""
    _note_pick()
    return 8, 32 if C <= 32 else 64 if C <= 64 else 128


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}: expected cuda or cpu")


def binary_matmul(x: torch.Tensor, B_packed: torch.Tensor, alpha: torch.Tensor, *,
                  K: int, group_size: int, m_active: int | None = None,
                  plan: tuple[int, int] | None = None) -> torch.Tensor:
    """y[..., N] = sum_{m<m_active} alpha_m ⊙ (x[..., K] @ B_m), summed in fp32
    and returned in x's dtype (as the JAX wrapper does).  The kernel reads
    an fp32 or bf16 x as it is (``binary_matmul.X_DTYPES``); any other
    dtype is cast to fp32 first.

    A ``meta`` x (the dry run) takes the card's route up to the launch and
    gets ``torch.empty`` of the result's shape in place of the kernel's
    output; no kernel and no plain version runs.  On the card and on
    ``meta`` each call is reported to an active ``CostCounter``, x counted
    at the width the kernel reads."""
    M, _, N = B_packed.shape
    m = min(m_active or M, M)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x.device.type == "meta":
        x2 = _kernel_x(x2)
        y = torch.empty((x2.shape[0], N), dtype=torch.float32, device="meta")
        _report(x2, N, B_packed, alpha)
    elif not _on_card(x):
        y = kref.binary_matmul_ref(x2, B_packed, alpha, K=K, group_size=group_size,
                                   m_active=m)
    else:
        x2 = _kernel_x(x2)
        y = bmk.launch(x2, B_packed, alpha, K=K, group_size=group_size, m_active=m,
                       plan=plan or pick_matmul_plan(x2.shape[0], N))
        if reporters:
            _report(x2, N, B_packed, alpha)
    return y.reshape(*lead, N).to(x.dtype)


def _kernel_x(x2: torch.Tensor) -> torch.Tensor:
    """x as the matmul kernel reads it: contiguous, in its own dtype where
    the kernel reads that dtype, else cast to fp32."""
    if x2.dtype not in bmk.X_DTYPES:
        x2 = x2.to(torch.float32)
    return x2.contiguous()


def _report(x2: torch.Tensor, N: int, B_packed: torch.Tensor, alpha: torch.Tensor) -> None:
    T, K = x2.shape
    for counter in reporters:
        counter.binary_matmul(T, K, N, B_packed, alpha, x_itemsize=x2.element_size())


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
    x = x.to(torch.float32).contiguous()
    B, H, W, _ = x.shape
    pads, (U, V) = conv_geometry(H, W, kh, kw, stride, padding)
    return bck.launch(x, B_tap_packed, alpha, bias, kh=kh, kw=kw, stride=stride,
                      pads=pads, out_hw=(U, V), pool=pool, m_active=m, relu=relu,
                      plan=plan or pick_conv_plan(B * U * V, B_tap_packed.shape[-1], pool))


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
    x = x.to(torch.float32).contiguous()
    B, H, W, C = x.shape
    pads, (U, V) = conv_geometry(H, W, kh, kw, stride, padding)
    return bdw.launch(x, B_tap_packed, alpha, bias, kh=kh, kw=kw, stride=stride,
                      pads=pads, out_hw=(U, V), m_active=m, relu=relu,
                      plan=plan or pick_dwconv_plan(C))
