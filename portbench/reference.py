"""The plain reference: the network in plain PyTorch, float32, TF32 off.

It rebuilds W_hat = sum over the levels in use of alpha_m * B_m from the
benchmark's own levels and alphas (``weights.py``) and runs the layers
with ``F.conv2d``, explicit SAME padding, bias, max-pool, ReLU, a mean and
a matmul.  It imports nothing of the port and takes nothing the port made.

``tf32=True`` is the control: the same computation with every conv and
matmul operand rounded to TF32 (10 mantissa bits, to nearest, ties away
from zero, as the tensor cores' conversion does) and summed in fp32, which
is what TF32 on the card computes.  It is emulated so that it reads the
same on the CPU and on the card.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.network import Layer


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32's 10 mantissa bits, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def w_hat(w: dict, m: int) -> torch.Tensor:
    """sum_{l < m} alpha_l * B_l in the layer's layout (alpha broadcast over
    the last axis, the output channel)."""
    B = w["B"][:m].to(torch.float32)
    alpha = w["alpha"][:m].reshape((m,) + (1,) * (B.dim() - 2) + (-1,))
    return (alpha * B).sum(0)


def _layer(layer: Layer, w: dict, x: torch.Tensor, m: int, tf32: bool) -> torch.Tensor:
    W = w_hat(w, m)
    op = round_tf32 if tf32 else (lambda t: t)
    if layer.pre == "flatten":
        x = x.reshape(x.shape[0], -1)
    elif layer.pre == "gap":
        x = x.mean(dim=(1, 2))
    if layer.kind == "linear":
        y = op(x) @ op(W) + w["bias"]
    else:
        pt, pb, pl, pr = layer.pads
        xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
        if layer.kind == "conv":
            wt = W.permute(3, 2, 0, 1)                 # [D, C, kh, kw]
            y = F.conv2d(op(xn), op(wt.contiguous()), stride=layer.stride)
        else:
            wt = W.permute(2, 0, 1).unsqueeze(1)       # [C, 1, kh, kw]
            y = F.conv2d(op(xn), op(wt.contiguous()), stride=layer.stride,
                         groups=xn.shape[1])
        y = y + w["bias"][None, :, None, None]
        if layer.pool > 1:
            y = F.max_pool2d(y, layer.pool)
        y = y.permute(0, 2, 3, 1)
    return torch.relu(y) if layer.relu else y


@torch.no_grad()
def forward(net: list[Layer], weights: dict, x: torch.Tensor, sched: list[int], *,
            tf32: bool = False) -> torch.Tensor:
    """Logits [B, classes] of NHWC ``x`` with ``sched[i]`` levels in layer i."""
    y = x.to(torch.float32)
    with tf32_off():
        for layer, m in zip(net, sched):
            y = _layer(layer, weights[layer.name], y, m, tf32)
    return y.contiguous()
