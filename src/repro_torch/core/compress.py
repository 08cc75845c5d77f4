"""Binary gradient compression with error feedback (port of
``repro/core/compress.py``; beyond the paper).

The paper's greedy multi-level binarization (Algorithm 1, steps 1-5, one
alpha per tensor) applied to gradients: each leaf becomes M sign tensors
and M scales (32/M x fewer bits on the wire), and the compression residual
is kept locally ("error feedback", Karimireddy et al. 2019) so its bias
vanishes over steps.  The compressed gradient goes straight to the
optimizer.

On a mesh (``launch/steps.py``) the gradients arrive as DTensors on their
params' placements, already the mean over the global batch, as the JAX
package's compression sees them inside its jitted step; the error leaves
sit on the same placements (:func:`init_state`).  Signs and residuals are
taken on each rank's local shard; each level's alpha is the global mean of
``|r|``: the shard's sum, summed over the ranks that hold the leaf's other
shards (``placement.sum_over_shards``), over the global element count.  No
leaf is gathered whole.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.sharding import placement as pl


class CompressionState(NamedTuple):
    error: dict  # per-leaf residual memory (fp32)


def init_state(grads) -> CompressionState:
    """Zero residuals shaped like ``grads`` (or the params), fp32; a
    DTensor leaf's on its placements, each rank holding its own shard."""
    def zeros(g):
        if not pl.is_dtensor(g):
            return torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        loc = g.to_local()
        return pl.from_local(torch.zeros(loc.shape, dtype=torch.float32, device=loc.device),
                             g.device_mesh, g.placements, g.shape)
    return CompressionState(error=tree_map(zeros, grads))


def compress_leaf(g: torch.Tensor, e: torch.Tensor, M: int):
    """Greedy M-level binarization of ``g + e`` (error feedback) with one
    alpha per level and tensor -> (reconstruction in g's dtype, residual
    fp32, the M alphas as a tensor ``[M]``).  Over DTensors (``e`` on
    ``g``'s placements) the signs and residuals are the rank's shard's and
    each alpha the global mean."""
    def mean_abs(r):
        if not pl.is_dtensor(g):
            return torch.mean(torch.abs(r))
        return pl.sum_over_shards(torch.sum(torch.abs(r)), g) / g.numel()

    r = pl.local(g).to(torch.float32) + pl.local(e)
    recon = torch.zeros_like(r)
    alphas = []
    for _ in range(M):
        b = torch.where(r >= 0, 1.0, -1.0)
        a = mean_abs(r)
        r = r - a * b
        recon = recon + b * a
        alphas.append(a)
    recon = recon.to(g.dtype)
    if pl.is_dtensor(g):
        recon, r = (pl.from_local(t, g.device_mesh, g.placements, g.shape) for t in (recon, r))
    return recon, r, torch.stack(alphas)


@torch.no_grad()
def compress_grads(grads, state: CompressionState, *, M: int = 2):
    """-> (compressed-reconstructed grads, new state)."""
    out = tree_map(lambda g, e: compress_leaf(g, e, M), grads, state.error)
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
