"""Binary-approximated convolution helpers (paper §III) in PyTorch, NHWC.

Port of ``repro/core/binconv.py``: asymmetric SAME padding, im2col (which
the plain conv version uses), and offline packing of conv and depth-wise
filters into the kernels' per-tap layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as bz
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels.binary_conv import pack_taps
from repro_torch.kernels.binary_dwconv import pack_dw_taps


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA-convention SAME padding (lo, hi) for one spatial dim: the extra
    element goes on the *high* side, so even kernels and stride 2 pad
    asymmetrically (a symmetric ``padding=`` would be off by one)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_geometry(H: int, W: int, kh: int, kw: int, stride: int,
                  padding: str) -> tuple[tuple[int, int], tuple[int, int]]:
    """``((pad_top, pad_left), (U, V))`` of a conv over an ``H x W`` map: the
    low-side pads ``pad_nhwc`` would add and the output size, computed
    without padding anything (the depth-wise kernel masks its border taps)."""
    if padding == "VALID":
        return (0, 0), ((H - kh) // stride + 1, (W - kw) // stride + 1)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    (pt, pb), (pl, pr) = same_pads(H, kh, stride), same_pads(W, kw, stride)
    return (pt, pl), ((H + pt + pb - kh) // stride + 1, (W + pl + pr - kw) // stride + 1)


def pad_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str) -> torch.Tensor:
    """Resolve ``padding`` ("SAME" | "VALID") on an NHWC tensor."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    (pt, pb), (pl, pr) = same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride)
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "VALID") -> torch.Tensor:
    """x: [B, H, W, C] -> patches [B, U, V, kh*kw*C], K row-major over
    (tap_i, tap_j, c) like the paper's feature-buffer layout."""
    x = pad_nhwc(x, kh, kw, stride, padding)
    B, H, W, C = x.shape
    U = (H - kh) // stride + 1
    V = (W - kw) // stride + 1
    patches = torch.stack(
        [x[:, i: i + (U - 1) * stride + 1: stride, j: j + (V - 1) * stride + 1: stride, :]
         for i in range(kh) for j in range(kw)], dim=3)  # [B, U, V, kh*kw, C]
    return patches.reshape(B, U, V, kh * kw * C)


def binarize_conv_params(params: dict, quant: QuantConfig) -> dict:
    """fp conv filters ``w [kh, kw, C, D]`` -> ``{'B_tap_packed' [M, kh*kw,
    ceil(C/8), D], 'alpha' [M, G, D], 'b'?}``.  The reference also emits the
    flat ``B_packed`` stream for its im2col path; the port's plain conv
    reads the per-tap layout, so only that one is kept."""
    kh, kw, C, D = params["w"].shape
    W = params["w"].reshape(kh * kw * C, D).to(torch.float32)
    approx, _ = bz.approximate_tensor(W, quant.M, algorithm=quant.algorithm,
                                      K_iters=quant.K_iters, group_size=quant.group_size)
    out = {"B_tap_packed": pack_taps(approx.B, kh, kw, C), "alpha": approx.alpha}
    if "b" in params:
        out["b"] = params["b"]
    return out


def binarize_dwconv_params(params: dict, quant: QuantConfig) -> dict:
    """fp depth-wise filters ``w [kh, kw, 1, C]`` (HWIO) -> channel-wise
    ``{'B_tap_packed' [M, kh*kw, ceil(C/8)], 'alpha' [M, C], 'b'?}`` (paper
    §V-A3: each channel is one filter of kh·kw taps, G = 1)."""
    kh, kw, one, C = params["w"].shape
    if one != 1:
        raise ValueError(f"expected HWIO depth-wise filters [kh,kw,1,C], got "
                         f"{tuple(params['w'].shape)}")
    W = params["w"].reshape(kh * kw, C).to(torch.float32)
    approx, _ = bz.approximate_tensor(W, quant.M, algorithm=quant.algorithm,
                                      K_iters=quant.K_iters, group_size=None)
    out = {"B_tap_packed": pack_dw_taps(approx.B), "alpha": approx.alpha[:, 0, :]}
    if "b" in params:
        out["b"] = params["b"]
    return out
