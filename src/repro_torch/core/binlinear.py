"""Quantization config and offline packing of a binary linear layer.

Port of the deployment half of ``repro/core/binlinear.py``: ``QuantConfig``
limited to the fields the compile-once path reads, and ``binarize_params``
(fp ``{w, b}`` -> packed ``{B_packed, alpha, b}``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import binarize as bz


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "dense"             # dense | fake_quant | binary
    M: int = 2                      # number of binary levels (paper M)
    algorithm: int = 2              # 1 = Guo et al., 2 = paper's Algorithm 2
    K_iters: int = 8                # Algorithm 2 refinement budget
    group_size: int | None = None   # None = per-output-channel (paper)
    m_active: int | None = None     # runtime levels used (<= M); None = all

    def replace(self, **kw: Any) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


def binarize_params(params: dict, qc: QuantConfig) -> dict:
    """fp ``{'w': [K, N], 'b'?}`` -> ``{'B_packed': uint8 [M, ceil(K/8), N],
    'alpha': [M, G, N]}`` (+ bias kept); K is padded to a multiple of 8 with
    +1 rows, as in the reference."""
    W = params["w"].to(torch.float32)
    approx, _ = bz.approximate_tensor(W, qc.M, algorithm=qc.algorithm,
                                      K_iters=qc.K_iters, group_size=qc.group_size)
    out = {"B_packed": bz.pack_bits(bz.pad_rows_to_byte(approx.B)), "alpha": approx.alpha}
    if "b" in params:
        out["b"] = params["b"]
    return out
