"""The paper's evaluation networks (§V-A1) as LayerSpec lists, in PyTorch.

Port of ``repro/models/cnn.py``: the same ``LayerSpec`` lists (the single
topology source the forwards, the packing walk and the compiler share), the
same weight shapes and init scales (drawn from a ``torch.Generator``), the
offline packing walk, the training forwards over fp trees in ``dense`` and
``fake_quant`` modes (``cnn_a_forward``, ``mobilenet_forward``), and a plain
spec-driven forward over packed trees that runs the ``kernels/ref.py``
versions (``spec_forward``).

  * CNN-A: 2 conv (5@7x7x3, 150@4x4x5) + 3 dense (1350->340->490->43).
  * MobileNetV1 (CNN-B2 at width 1.0, 224²), depth-wise layers approximated
    channel-wise (paper §V-A3).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.core import binconv
from repro_torch.core import binlinear as bl
from repro_torch.core.binlinear import DENSE, QuantConfig
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer.  ``pre`` is the activation transform
    before the layer ("flatten" for conv->dense, "gap" for the global
    average pool); ``pool``/``relu`` describe the epilogue after it."""

    name: str
    kind: str                 # conv | dwconv | linear
    kh: int = 1
    kw: int = 1
    stride: int = 1
    padding: str = "VALID"    # conv only; dw layers are always SAME
    pool: int = 1             # max-pool window after the layer (1 = none)
    pre: str = "none"         # none | flatten | gap
    relu: bool = True


def apply_pre(pre: str, y: torch.Tensor) -> torch.Tensor:
    """A spec's pre-layer transform.  ``flatten`` flattens NHWC (so fc1's
    1350 inputs come in (h, w, c) order, as in the reference)."""
    if pre == "flatten":
        return y.reshape(y.shape[0], -1)
    if pre == "gap":
        return torch.mean(y, dim=(1, 2))
    if pre != "none":
        raise ValueError(f"unknown pre-op {pre!r}")
    return y


# conv1 7x7 VALID -> 42x42x5, pool 2 -> 21x21x5
# conv2 4x4 VALID -> 18x18x150, pool 6 -> 3x3x150 = 1350 -> 340 -> 490 -> 43
CNN_A_INPUT = (48, 48, 3)
CNN_A_CLASSES = 43
CNN_A_SPECS = (
    LayerSpec("conv1", "conv", kh=7, kw=7, pool=2),
    LayerSpec("conv2", "conv", kh=4, kw=4, pool=6),
    LayerSpec("fc1", "linear", pre="flatten"),
    LayerSpec("fc2", "linear"),
    LayerSpec("fc3", "linear", relu=False),
)

MOBILENET_BLOCKS = [
    # (stride, out_channels) after the stem; standard MobileNetV1
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024),
]

MOBILENET_SPECS = (
    (LayerSpec("stem", "conv", kh=3, kw=3, stride=2, padding="SAME"),)
    + tuple(
        spec
        for i, (stride, _) in enumerate(MOBILENET_BLOCKS)
        for spec in (LayerSpec(f"dw{i}", "dwconv", kh=3, kw=3, stride=stride),
                     LayerSpec(f"pw{i}", "conv", kh=1, kw=1))
    )
    + (LayerSpec("head", "linear", pre="gap", relu=False),)
)


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """N(0, scale²) drawn on the CPU from ``gen`` (so a seed gives the same
    weights on every device), then moved to ``device``."""
    return (torch.randn(shape, generator=gen) * scale).to(device)


def init_cnn_a(gen: torch.Generator, *, device="cuda") -> dict:
    """fp CNN-A weights: conv filters HWIO ``[kh, kw, C, D]`` scaled by
    1/sqrt(fan_in), linears ``[K, N]`` LeCun-normal, zero biases."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        return {"w": _normal(gen, (kh, kw, cin, cout), 1.0 / math.sqrt(kh * kw * cin), dev),
                "b": torch.zeros(cout, device=dev)}

    def linear(k, n):
        return {"w": _normal(gen, (k, n), 1.0 / math.sqrt(k), dev),
                "b": torch.zeros(n, device=dev)}

    return {"conv1": conv(7, 7, 3, 5), "conv2": conv(4, 4, 5, 150),
            "fc1": linear(1350, 340), "fc2": linear(340, 490), "fc3": linear(490, 43)}


def init_mobilenet(gen: torch.Generator, *, width_mult: float = 1.0,
                   n_classes: int = 1000, device="cuda") -> dict:
    """fp MobileNetV1 weights with the reference's shapes and scales: stem
    and depth-wise filters N(0, 0.1²) (depth-wise HWIO ``[3, 3, 1, C]``),
    point-wise 1/sqrt(C_in), LeCun-normal head, zero biases."""
    dev = resolve_device(device)

    def c(ch):
        return max(8, int(ch * width_mult))

    params = {"stem": {"w": _normal(gen, (3, 3, 3, c(32)), 0.1, dev),
                       "b": torch.zeros(c(32), device=dev)}}
    cin = c(32)
    for i, (_, cout) in enumerate(MOBILENET_BLOCKS):
        cout = c(cout)
        params[f"dw{i}"] = {"w": _normal(gen, (3, 3, 1, cin), 0.1, dev),
                            "b": torch.zeros(cin, device=dev)}
        params[f"pw{i}"] = {"w": _normal(gen, (1, 1, cin, cout), 1.0 / math.sqrt(cin), dev),
                            "b": torch.zeros(cout, device=dev)}
        cin = cout
    params["head"] = {"w": _normal(gen, (cin, n_classes), 1.0 / math.sqrt(cin), dev),
                      "b": torch.zeros(n_classes, device=dev)}
    return params


def spec_binarize(specs, params: dict, quant: QuantConfig) -> dict:
    """Offline conversion of every layer to its packed deployment form."""
    out = {}
    for s in specs:
        if s.kind == "conv":
            out[s.name] = binconv.binarize_conv_params(params[s.name], quant)
        elif s.kind == "dwconv":
            out[s.name] = binconv.binarize_dwconv_params(params[s.name], quant)
        else:
            out[s.name] = bl.binarize_params(params[s.name], quant)
    return out


def spec_forward(specs, params: dict, x: torch.Tensor,
                 quant: QuantConfig = QuantConfig(mode="binary")) -> torch.Tensor:
    """Plain forward over a packed tree with the ``kernels/ref.py`` versions,
    applying ``quant.m_active`` levels in every layer.  x [B, H, W, C] NHWC."""
    y = x.to(torch.float32)
    for s in specs:
        p = params[s.name]
        y = apply_pre(s.pre, y)
        if s.kind == "conv":
            y = kref.fused_binary_conv_relu_pool_ref(
                y, p["B_tap_packed"], p["alpha"], kh=s.kh, kw=s.kw, stride=s.stride,
                padding=s.padding, pool=s.pool, m_active=quant.m_active,
                bias=p.get("b"), relu=s.relu)
        elif s.kind == "dwconv":
            y = kref.binary_dwconv_relu_ref(
                y, p["B_tap_packed"], p["alpha"], kh=s.kh, kw=s.kw, stride=s.stride,
                padding="SAME", m_active=quant.m_active, bias=p.get("b"), relu=s.relu)
        else:
            K = y.shape[-1]
            y = kref.binary_matmul_ref(y, p["B_packed"], p["alpha"], K=K,
                                       group_size=K // p["alpha"].shape[1],
                                       m_active=quant.m_active)
            if "b" in p:
                y = y + p["b"].to(torch.float32)
            if s.relu:
                y = torch.relu(y)
    return y


def _forward(specs, params: dict, x: torch.Tensor, quant: QuantConfig) -> torch.Tensor:
    """Spec-driven forward over an fp tree, ``dense`` or ``fake_quant``.
    Every conv stage ends in the AMU's max-pool + ReLU, as in the reference."""
    y = x
    for s in specs:
        y = apply_pre(s.pre, y)
        if s.kind == "conv":
            y = binconv.conv2d_relu_pool(params[s.name], y, stride=s.stride,
                                         padding=s.padding, pool=s.pool, quant=quant)
        elif s.kind == "dwconv":
            y = binconv.depthwise_relu(params[s.name], y, stride=s.stride, quant=quant)
        else:
            y = bl.apply_linear(params[s.name], y, quant)
            if s.relu:
                y = torch.relu(y)
    return y


def cnn_a_forward(params: dict, x: torch.Tensor, quant: QuantConfig = DENSE) -> torch.Tensor:
    """x [B, 48, 48, 3] -> logits [B, 43] over an fp tree (the training
    paths); packed trees go through ``deploy`` or ``spec_forward``."""
    return _forward(CNN_A_SPECS, params, x, quant)


def mobilenet_forward(params: dict, x: torch.Tensor,
                      quant: QuantConfig = DENSE) -> torch.Tensor:
    """x [B, R, R, 3] -> logits over an fp tree; depth-wise layers are
    approximated channel-wise in ``fake_quant`` (paper §V-A3)."""
    return _forward(MOBILENET_SPECS, params, x, quant)


def binarize_cnn_a(params: dict, quant: QuantConfig) -> dict:
    """Offline conversion of every CNN-A layer to packed-binary form."""
    return spec_binarize(CNN_A_SPECS, params, quant)


def binarize_mobilenet(params: dict, quant: QuantConfig) -> dict:
    """Offline conversion of every MobileNet layer to packed-binary form."""
    return spec_binarize(MOBILENET_SPECS, params, quant)


def cnn_a_macs() -> int:
    """Analytic MAC count of CNN-A (the paper says ~9M)."""
    m_conv1 = 42 * 42 * 5 * 7 * 7 * 3
    m_conv2 = 18 * 18 * 150 * 4 * 4 * 5
    m_fc = 1350 * 340 + 340 * 490 + 490 * 43
    return m_conv1 + m_conv2 + m_fc
