"""Plain PyTorch versions of the three CUDA kernels (port of
``repro/kernels/ref.py``).

They unpack the bits and compute with ordinary tensor ops, NHWC, in fp32.
``kernels/ops.py`` takes them for CPU tensors, the CPU tests compare them
with the JAX oracles, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  Nothing on the deployment path calls them when a card is
present.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as bz
from repro_torch.core.binconv import im2col, pad_nhwc
from repro_torch.kernels.binary_conv import unpack_taps
from repro_torch.kernels.binary_dwconv import unpack_dw_taps


def _levels(M: int, m_active: int | None) -> int:
    return min(m_active or M, M)   # §IV-D: no more levels than were packed


def _grouped_matmul(x: torch.Tensor, B: torch.Tensor, alpha: torch.Tensor,
                    group_size: int) -> torch.Tensor:
    """sum_{m,g} alpha[m, g, n] * (x[..., g-th group] @ B[m, g-th group, n])
    for unpacked ±1 ``B [m, K, N]`` and ``alpha [>=m, G, N]``."""
    m, K, N = B.shape
    G = K // group_size
    xf = x.to(torch.float32)
    xg = xf.reshape(*xf.shape[:-1], G, group_size)
    Bg = B.to(torch.float32).reshape(m, G, group_size, N)
    p = torch.einsum("...gk,mgkn->...mgn", xg, Bg)
    return torch.einsum("...mgn,mgn->...n", p, alpha[:m].to(torch.float32))


def binary_matmul_ref(x: torch.Tensor, B_packed: torch.Tensor, alpha: torch.Tensor, *,
                      K: int, group_size: int, m_active: int | None = None) -> torch.Tensor:
    """y = sum_{m<m_active} alpha_m ⊙ (x @ B_m) (paper Eq. 8, grouped alpha).
    x [..., K]; B_packed [M, ceil(K/8), N] uint8; alpha [M, G, N] -> [..., N] f32."""
    M, K8, N = B_packed.shape
    m = _levels(M, m_active)
    B = bz.unpack_bits(B_packed[:m], K8 * 8)[:, :K, :]
    return _grouped_matmul(x, B, alpha, group_size)


def fused_binary_conv_relu_pool_ref(
        x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor, *,
        kh: int, kw: int, stride: int = 1, padding: str = "VALID", pool: int = 1,
        m_active: int | None = None, bias: torch.Tensor | None = None,
        relu: bool = True) -> torch.Tensor:
    """Explicit im2col + binary matmul + bias + 2D max-pool + ReLU.

    Unlike the JAX oracle, which reads the flat ``B_packed`` stream, this
    reads the per-tap ``B_tap_packed`` layout the program carries; the CPU
    tests give the two their own packing of the same ±1 tensor, which keeps
    both layouts cross-checked.  x [B, H, W, C] -> [B, U//pool, V//pool, D].
    """
    C = x.shape[-1]
    m = _levels(B_tap_packed.shape[0], m_active)
    patches = im2col(x.to(torch.float32), kh, kw, stride, padding)
    K = patches.shape[-1]
    y = _grouped_matmul(patches, unpack_taps(B_tap_packed[:m], C), alpha,
                        K // alpha.shape[1])
    if bias is not None:
        y = y + bias.to(torch.float32)
    B, U, V, D = y.shape
    y = y.reshape(B, U // pool, pool, V // pool, pool, D).amax(dim=(2, 4))
    return torch.relu(y) if relu else y


def binary_dwconv_relu_ref(
        x: torch.Tensor, B_tap_packed: torch.Tensor, alpha: torch.Tensor, *,
        kh: int, kw: int, stride: int = 1, padding: str = "SAME",
        m_active: int | None = None, bias: torch.Tensor | None = None,
        relu: bool = True) -> torch.Tensor:
    """Reconstruct W_hat[t, c] = sum_{m<m_active} alpha[m, c] B[m, t, c] and
    run it through a grouped ``F.conv2d``.  x [B, H, W, C] -> [B, U, V, C]."""
    C = x.shape[-1]
    m = _levels(B_tap_packed.shape[0], m_active)
    B = unpack_dw_taps(B_tap_packed[:m], C).to(torch.float32)       # [m, T, C]
    W_hat = torch.einsum("mtc,mc->tc", B, alpha[:m].to(torch.float32))
    w = W_hat.reshape(kh, kw, C).permute(2, 0, 1).unsqueeze(1)      # [C, 1, kh, kw]
    xp = pad_nhwc(x.to(torch.float32), kh, kw, stride, padding).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w, stride=stride, groups=C).permute(0, 2, 3, 1).contiguous()
    if bias is not None:
        y = y + bias.to(torch.float32)
    return torch.relu(y) if relu else y
