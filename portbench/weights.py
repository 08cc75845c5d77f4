"""Weights and inputs drawn from the run's seed, on the device, in a few
large calls.

The benchmark draws the binary approximation itself: for each layer M
levels of ±1 weights and one alpha per (level, output channel), plus a
bias, as the configuration's ``weights`` block states.  The port packs and
compiles them (``port.py``); the reference rebuilds W_hat from the same
tensors (``reference.py``).  Layouts here are the benchmark's own:

  conv    B [M, kh, kw, C, D]   alpha [M, D]   bias [D]
  dwconv  B [M, kh, kw, C]      alpha [M, C]   bias [C]
  linear  B [M, K, N]           alpha [M, N]   bias [N]

K of a linear runs over its input in NHWC order, as a flatten of NHWC gives.
"""
from __future__ import annotations

import math

import torch

from portbench.network import Layer

_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one stream of one seed (weights 1, inputs 2, ...):
    the same (seed, stream) gives the same numbers on the same device type."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & _MASK)
    return g


def _level_shape(layer: Layer, M: int) -> tuple[int, ...]:
    if layer.kind == "conv":
        C = layer.in_shape[-1]
        return (M, layer.kh, layer.kw, C, layer.n_alpha)
    if layer.kind == "dwconv":
        return (M, layer.kh, layer.kw, layer.n_alpha)
    return (M, layer.in_shape[0], layer.n_alpha)


def draw(net: list[Layer], spec: dict, levels: int, seed: int, device) -> dict:
    """``{layer name: {"B": int8 ±1, "alpha": fp32, "bias": fp32}}`` for
    ``net`` at ``levels`` levels, by ``spec`` (a configuration's ``weights``)."""
    g = generator(seed, 1, device)
    ratio = torch.tensor(spec["alpha_level_ratio"][:levels], dtype=torch.float32,
                         device=device)
    if ratio.numel() != levels:
        raise ValueError(f"alpha_level_ratio gives {ratio.numel()} levels, need {levels}")
    shapes = [_level_shape(layer, levels) for layer in net]
    sizes = [math.prod(s) for s in shapes]
    bits = torch.randint(0, 2, (sum(sizes),), generator=g, device=device,
                         dtype=torch.int8) * 2 - 1
    n_alpha = [levels * layer.n_alpha for layer in net]
    jit = spec["alpha_jitter"]
    jitter = 1.0 - jit + 2.0 * jit * torch.rand(sum(n_alpha), generator=g, device=device)
    bias = spec["bias_scale"] * (2.0 * torch.rand(sum(layer.n_bias for layer in net),
                                                  generator=g, device=device) - 1.0)
    out = {}
    b0 = a0 = c0 = 0
    for layer, shape, size, na in zip(net, shapes, sizes, n_alpha):
        scale = math.sqrt(spec["alpha_gain"] / (layer.fan_in * float((ratio ** 2).sum())))
        alpha = (ratio[:, None] * scale) * jitter[a0:a0 + na].reshape(levels, -1)
        out[layer.name] = {"B": bits[b0:b0 + size].reshape(shape),
                           "alpha": alpha.contiguous(),
                           "bias": bias[c0:c0 + layer.n_bias]}
        b0, a0, c0 = b0 + size, a0 + na, c0 + layer.n_bias
    return out


def images(shape: tuple[int, ...], seed: int, stream: int, device) -> torch.Tensor:
    """N(0, 1) NHWC images of ``shape`` for one stream of the seed."""
    return torch.randn(shape, generator=generator(seed, stream, device), device=device)
