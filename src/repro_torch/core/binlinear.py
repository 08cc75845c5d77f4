"""Quantizable linear layer (port of ``repro/core/binlinear.py``).

Two execution modes of ``apply_linear``, keyed on the params' form:

  * packed trees (``B_packed`` present) take the binary path,
    ``y = sum_{m<m_active} alpha_m (x @ B_m)`` (paper Eq. 8), through
    ``kernels/ops.binary_matmul``, which launches the CUDA kernel for a
    tensor on the card and runs the plain version for one on the CPU;
  * fp trees follow ``qc.mode``: ``dense`` runs ``x @ W``; ``fake_quant``
    (QAT / retraining, paper §V-B1) runs ``x @ W_hat`` with W_hat the
    Algorithm 1/2 reconstruction of W and a straight-through gradient to the
    latent fp weights (``binarize.fake_quant``).

``m_active`` is the paper's runtime accuracy<->throughput switch (§IV-D);
``m_schedule`` gives it per decoder layer (``models/common.layer_quant_cfg``
resolves it).  The JAX package's ``use_pallas`` / ``interpret`` /
``fuse_conv`` select TPU routes; the port routes by device instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import binarize as bz


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "dense"             # dense | fake_quant | binary
    M: int = 2                      # number of binary levels (paper M)
    algorithm: int = 2              # 1 = Guo et al., 2 = paper's Algorithm 2
    K_iters: int = 8                # Algorithm 2 refinement budget
    group_size: int | None = None   # None = per-output-channel (paper)
    m_active: int | None = None     # runtime levels used (<= M); None = all
    m_schedule: tuple[int, ...] | None = None  # per-layer §IV-D schedule:
                                    # entry i is m_active for decoder layer i

    def replace(self, **kw: Any) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


DENSE = QuantConfig(mode="dense")


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, scale: float | None = None, *,
                device="cuda") -> dict:
    """LeCun-normal weight ``{'w': [K, N]}``, drawn from ``gen`` on the
    generator's own device, then moved to ``device`` (raises without a card
    when that is CUDA)."""
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device) * s
    return {"w": w.to(device=resolve_device(device), dtype=dtype)}


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


def apply_linear(params: dict, x: torch.Tensor, qc: QuantConfig = DENSE) -> torch.Tensor:
    """y = quantized-linear(x): x [..., K] -> [..., N] in x's dtype."""
    if "B_packed" in params:
        y = _apply_binary(params, x, qc)
    elif qc.mode == "fake_quant":
        W_hat = bz.fake_quant(params["w"].to(torch.float32), qc.M, algorithm=qc.algorithm,
                              K_iters=qc.K_iters, group_size=qc.group_size)
        y = x @ W_hat.to(x.dtype)
    else:
        y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _apply_binary(params: dict, x: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """Deployment path over packed weights (paper Eq. 8); K and group_size
    are re-derived from shapes (K = x's trailing dim, group_size = K // G)."""
    from repro_torch.kernels import ops as kops   # ops -> binconv -> this module

    K = x.shape[-1]
    return kops.binary_matmul(x, params["B_packed"], params["alpha"], K=K,
                              group_size=K // params["alpha"].shape[1],
                              m_active=qc.m_active or params["alpha"].shape[0])
