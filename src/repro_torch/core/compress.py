"""Binary gradient compression with error feedback (port of
``repro/core/compress.py``; beyond the paper).

The paper's greedy multi-level binarization (Algorithm 1, steps 1-5, one
alpha per tensor) applied to gradients: each leaf becomes M sign tensors
and M scales (32/M x fewer bits on the wire), and the compression residual
is kept locally ("error feedback", Karimireddy et al. 2019) so its bias
vanishes over steps.  The compressed gradient goes straight to the
optimizer on one device; the mesh train step (``launch/steps.py``) refuses
compression, so its all-reduce of compressed gradients is not ported
(ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class CompressionState(NamedTuple):
    error: dict  # per-leaf residual memory (fp32)


def init_state(grads) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads))


def _compress_leaf(g: torch.Tensor, e: torch.Tensor, M: int):
    """Greedy M-level binarization of ``g + e`` (error feedback) with one
    alpha per level and tensor -> (reconstruction in g's dtype, residual
    fp32)."""
    r = g.to(torch.float32) + e
    recon = torch.zeros_like(r)
    for _ in range(M):
        b = torch.where(r >= 0, 1.0, -1.0)
        a = torch.mean(torch.abs(r))
        r = r - a * b
        recon = recon + b * a
    return recon.to(g.dtype), r


@torch.no_grad()
def compress_grads(grads, state: CompressionState, *, M: int = 2):
    """-> (compressed-reconstructed grads, new state)."""
    out = tree_map(lambda g, e: _compress_leaf(g, e, M), grads, state.error)
    return (tree_map(lambda o: o[0], out),
            CompressionState(error=tree_map(lambda o: o[1], out)))


def wire_bytes(grads, M: int) -> tuple[int, int]:
    """(compressed, uncompressed) bytes per all-reduce of ``grads``."""
    comp = unc = 0
    for g in tree_leaves(grads):
        n = g.numel()
        unc += n * 4                       # fp32 wire
        comp += M * (n // 8 + 4)           # M x (1 bit/elem + fp32 alpha)
    return comp, unc
