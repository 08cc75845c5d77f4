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

Over a mesh (weights that are DTensors, ``launch/steps.py``) every linear
is column-parallel: the rank's input rows are gathered whole along K and
its output columns are computed whole, by the kernel on the rank's local
column shard for a packed tree and by Algorithm 2 on the local columns for
fake_quant (both reduce over K, which is never split).  The output is a
DTensor split on ``"model"``.

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
from repro_torch.sharding import placement as pl


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


def packed_shapes(params: dict, qc: QuantConfig) -> dict:
    """``binarize_params``'s output as ``meta`` tensors, from ``params``'
    shapes alone: ``B_packed`` uint8 [M, ceil(K/8), N], ``alpha`` float32
    [M, G, N] (G = K // group_size, 1 per output channel), ``b`` kept."""
    K, N = params["w"].shape
    G = 1 if qc.group_size is None else K // qc.group_size
    out = {"B_packed": torch.empty((qc.M, -(-K // 8), N), dtype=torch.uint8, device="meta"),
           "alpha": torch.empty((qc.M, G, N), dtype=torch.float32, device="meta")}
    if "b" in params:
        out["b"] = params["b"]
    return out


def apply_linear(params: dict, x: torch.Tensor, qc: QuantConfig = DENSE) -> torch.Tensor:
    """y = quantized-linear(x): x [..., K] -> [..., N] in x's dtype."""
    if "B_packed" in params:
        y = _apply_binary(params, x, qc)
    elif qc.mode == "fake_quant":
        y = x @ _fake_quant_weight(params["w"], qc).to(x.dtype)
    else:
        y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def _fake_quant_weight(w: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """STE(W_hat) of an fp weight; a DTensor weight is binarized on the
    rank's whole-K column shard (its FSDP dim gathered first, so Algorithm
    2's per-column alpha sees whole columns)."""
    def quant(W):
        return bz.fake_quant(W.to(torch.float32), qc.M, algorithm=qc.algorithm,
                             K_iters=qc.K_iters, group_size=qc.group_size)

    if not pl.is_dtensor(w):
        return quant(w)
    cols, placements = pl.columns(w)
    return pl.from_local(quant(cols), w.device_mesh, placements, w.shape)


def _apply_binary(params: dict, x: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """Deployment path over packed weights (paper Eq. 8); K and group_size
    are re-derived from shapes (K = x's trailing dim, group_size = K // G).
    With DTensor weights the kernel runs on the rank's column shard and the
    rank's rows of x (``sharding/placement.py``): it launches there or
    raises, it never falls back to gathering the whole weight."""
    from repro_torch.kernels import ops as kops   # ops -> binconv -> this module

    B_packed, alpha = params["B_packed"], params["alpha"]
    K = x.shape[-1]
    m_active = qc.m_active or alpha.shape[0]
    if not pl.is_dtensor(B_packed):
        return kops.binary_matmul(x, B_packed, alpha, K=K, group_size=K // alpha.shape[1],
                                  m_active=m_active)
    mesh = B_packed.device_mesh
    (B_loc, _), (a_loc, _) = pl.columns(B_packed), pl.columns(alpha)
    x_loc, rows = pl.rows_local(x, mesh)
    y = kops.binary_matmul(x_loc, B_loc, a_loc, K=K, group_size=K // a_loc.shape[1],
                           m_active=m_active)
    return pl.columns_out(y, mesh, rows, tuple(x.shape[:-1]) + (B_packed.shape[-1],))
