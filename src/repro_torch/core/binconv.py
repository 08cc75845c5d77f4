"""Binary-approximated convolution (paper §III) in PyTorch, NHWC.

Port of ``repro/core/binconv.py``: asymmetric SAME padding, im2col (which
the plain conv version uses), offline packing of conv and depth-wise
filters into the kernels' per-tap layouts, and the fp forwards that
training runs over fp trees, in ``dense`` and ``fake_quant`` modes:

  * ``conv2d``: im2col + matmul, as the JAX package does (no cuDNN, so no
    TF32 and no asymmetric-padding pitfall), with W_hat in ``fake_quant``;
  * ``relu_maxpool`` (the AMU: max-pool, then ReLU) and the unfused
    ``conv2d_relu_pool``;
  * ``depthwise_relu``: ``F.conv2d(groups=C)`` over the SAME-padded input,
    channel-wise W_hat in ``fake_quant``.

Packed trees do not come here: ``deploy.compile`` / ``execute`` run them on
the kernels, ``models/cnn.spec_forward`` on the plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as bz
from repro_torch.core.binlinear import DENSE, QuantConfig
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


def _fp_weights(params: dict, where: str) -> torch.Tensor:
    if "w" not in params:
        raise ValueError(f"{where} takes fp trees ('w'); packed trees run through "
                         "deploy.compile/execute or models.cnn.spec_forward")
    return params["w"]


def conv2d(params: dict, x: torch.Tensor, *, stride: int = 1, padding: str = "VALID",
           quant: QuantConfig = DENSE) -> torch.Tensor:
    """Conv via im2col + (dense | fake-quant) matmul, plus bias.
    params['w']: HWIO [kh, kw, C, D]; x NHWC."""
    w = _fp_weights(params, "conv2d")
    if quant.mode not in ("dense", "fake_quant"):
        raise ValueError(f"conv2d over fp trees runs dense or fake_quant, not {quant.mode!r}")
    kh, kw, C, D = w.shape
    patches = im2col(x, kh, kw, stride, padding)
    B, U, V, K = patches.shape
    W = w.reshape(K, D)
    if quant.mode == "fake_quant":
        W = bz.fake_quant(W.to(torch.float32), quant.M, algorithm=quant.algorithm,
                          K_iters=quant.K_iters, group_size=quant.group_size)
    y = (patches.reshape(B * U * V, K) @ W.to(patches.dtype)).reshape(B, U, V, D)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def relu_maxpool(x: torch.Tensor, pool: int) -> torch.Tensor:
    """AMU: max-pool (downsampling only, paper §III-B), then ReLU.  ReLU is
    ``maximum(y, 0)``, whose gradient at a tie is split in half, as
    ``jnp.maximum``'s is."""
    B, H, W, C = x.shape
    if H % pool or W % pool:
        raise ValueError(f"pool {pool} must divide the {H}x{W} map (downsampling only, "
                         "paper §III-B)")
    y = x if pool == 1 else x.reshape(B, H // pool, pool, W // pool, pool, C).amax(dim=(2, 4))
    return torch.maximum(y, y.new_zeros(()))


def conv2d_relu_pool(params: dict, x: torch.Tensor, *, stride: int = 1,
                     padding: str = "VALID", pool: int = 1,
                     quant: QuantConfig = DENSE) -> torch.Tensor:
    """Conv + bias + max-pool + ReLU, the paper's PE -> PA -> AMU pipeline,
    unfused (the fused form is the ``binary_conv`` kernel of ``deploy``)."""
    return relu_maxpool(conv2d(params, x, stride=stride, padding=padding, quant=quant), pool)


def _dwconv_fp(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """fp depth-wise conv, SAME padding (asymmetric, high side first).
    w: HWIO [kh, kw, 1, C]; x NHWC."""
    kh, kw, _, C = w.shape
    xp = pad_nhwc(x, kh, kw, stride, "SAME").permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride, groups=C)
    return y.permute(0, 2, 3, 1)


def depthwise_relu(params: dict, x: torch.Tensor, *, stride: int = 1,
                   quant: QuantConfig = DENSE) -> torch.Tensor:
    """Depth-wise conv + bias + ReLU, the paper's §V-A3 channel-wise stage,
    over fp trees: in ``fake_quant`` mode through the channel-wise W_hat
    (each channel one filter of kh·kw taps, as ``binarize_dwconv_params``),
    otherwise dense.  Always SAME padding (MobileNet's only variant)."""
    w = _fp_weights(params, "depthwise_relu")
    if quant.mode == "fake_quant":
        kh, kw, one, C = w.shape
        W_hat = bz.fake_quant(w.reshape(kh * kw, C).to(torch.float32), quant.M,
                              algorithm=quant.algorithm, K_iters=quant.K_iters,
                              group_size=None)
        w = W_hat.reshape(kh, kw, one, C)
    y = _dwconv_fp(w, x, stride)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return torch.relu(y)
