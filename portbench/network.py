"""A configuration's layers: their geometry and the work each must do.

Everything is worked out from the configuration file alone (its input size
and its layer list), never from the port's ``LayerStats``, so the counts
stay the same whatever implements a layer.

``work`` is a frozen copy of ``work()`` in ``chip_smoke.py`` (as of the
port's bring-up), restated over this geometry: each input is read once (x
in fp32, the packed bits of the levels in use, alpha, bias), the output is
written once after the fused pool, and each dense multiply-accumulate is
2 FLOPs (the kernels fold the levels into one fp32 weight and sum in FFMA).
"""
from __future__ import annotations

import dataclasses
import math

KINDS = ("conv", "dwconv", "linear")


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer at one image: ``in_shape`` is what the layer's core
    function reads (after ``pre``), ``out_shape`` what it writes (after
    the pool), both without the batch."""

    name: str
    kind: str
    kh: int
    kw: int
    stride: int
    padding: str
    pool: int
    pre: str
    relu: bool
    in_shape: tuple[int, ...]
    out_shape: tuple[int, ...]
    pads: tuple[int, int, int, int]   # top, bottom, left, right (convs)
    macs: int                         # dense multiply-accumulates per image
    fan_in: int                       # inputs summed into one output
    n_weights: int                    # binary weights per level
    n_alpha: int                      # alphas per level
    n_bias: int


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """SAME padding of one spatial dimension, the extra element on the high
    side (XLA's convention, which the port's compiler follows)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def layers(config: dict) -> list[Layer]:
    """The configuration's layers in order, with their shapes worked out
    from ``input_hwc``; raises where a layer does not fit its input."""
    shape = tuple(config["input_hwc"])
    out = []
    for spec in config["layers"]:
        kind = spec["kind"]
        if kind not in KINDS:
            raise ValueError(f"{spec['name']}: unknown layer kind {kind!r}")
        pre = spec.get("pre", "none")
        if pre == "flatten":
            shape = (math.prod(shape),)
        elif pre == "gap":
            shape = (shape[-1],)
        elif pre != "none":
            raise ValueError(f"{spec['name']}: unknown pre {pre!r}")
        kh, kw = spec.get("kh", 1), spec.get("kw", 1)
        stride, pool = spec.get("stride", 1), spec.get("pool", 1)
        padding = spec.get("padding", "VALID")
        if kind == "linear":
            (K,), N = shape, spec["out"]
            layer = dict(out_shape=(N,), pads=(0, 0, 0, 0), macs=K * N, fan_in=K,
                         n_weights=K * N, n_alpha=N, n_bias=N)
        else:
            H, W, C = shape
            if padding == "SAME":
                pads = same_pads(H, kh, stride) + same_pads(W, kw, stride)
            elif padding == "VALID":
                pads = (0, 0, 0, 0)
            else:
                raise ValueError(f"{spec['name']}: unknown padding {padding!r}")
            U = (H + pads[0] + pads[1] - kh) // stride + 1
            V = (W + pads[2] + pads[3] - kw) // stride + 1
            if U < 1 or V < 1 or U % pool or V % pool:
                raise ValueError(f"{spec['name']}: output {U}x{V} does not fit "
                                 f"pool {pool}")
            D = spec["out"] if kind == "conv" else C
            per_out = kh * kw * (C if kind == "conv" else 1)
            layer = dict(out_shape=(U // pool, V // pool, D), pads=pads,
                         macs=U * V * D * per_out, fan_in=per_out,
                         n_weights=per_out * D, n_alpha=D, n_bias=D)
        out.append(Layer(name=spec["name"], kind=kind, kh=kh, kw=kw, stride=stride,
                         padding=padding, pool=pool, pre=pre,
                         relu=bool(spec.get("relu", True)), in_shape=shape, **layer))
        shape = layer["out_shape"]
    return out


def macs_per_image(net: list[Layer]) -> int:
    return sum(layer.macs for layer in net)


def work(layer: Layer, batch: int, m: int) -> tuple[int, int]:
    """(bytes, FLOPs) one launch of ``layer`` at ``batch`` images and ``m``
    levels must move and do at least."""
    nbytes = (4 * batch * math.prod(layer.in_shape)
              + -(-m * layer.n_weights // 8) + 4 * m * layer.n_alpha
              + 4 * layer.n_bias + 4 * batch * math.prod(layer.out_shape))
    return nbytes, 2 * layer.macs * batch


def schedule(net: list[Layer], levels: int, m_active) -> list[int]:
    """Levels in use per layer for a traffic's ``m_active``: None is every
    packed level, an int is clamped to ``levels``, a list is one per layer."""
    if m_active is None:
        return [levels] * len(net)
    if isinstance(m_active, int):
        return [min(m_active, levels)] * len(net)
    if len(m_active) != len(net):
        raise ValueError(f"m_active has {len(m_active)} entries for {len(net)} layers")
    return [min(int(m), levels) for m in m_active]
