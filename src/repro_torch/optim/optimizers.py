"""Optimizers with in-place updates (port of ``repro/optim/optimizers.py``).

AdamW: the paper's CNN-A retraining optimizer (alpha=1e-4, b1=.9, b2=.999);
SGD+momentum: the paper's CNN-B recipe (momentum .9, exp-decayed lr from
5e-4; Adam was "susceptible to exploding gradients" there, §V-B1).

The formulas are the JAX package's: the global-norm clip (1.0 by default)
first, fp32 moments whatever the param dtype, bias correction from
``step + 1``, decoupled weight decay, and the update computed in fp32 and
rounded to the param's dtype.  Unlike the JAX package, which returns new
trees, ``update`` writes params and moments in place under ``no_grad``: a
functional update of a multi-GB model briefly holds two copies of params and
moments.  Each leaf is updated in pieces of at most ``PIECE`` elements (views
along its first dim), which bounds the fp32 scratch of one update to a few
pieces whatever the leaf's size.  DTensor params (a mesh,
``launch/steps.py``) are updated shard by shard: params, gradients and
moments share their placements, so the update, elementwise, runs on each
rank's local shards, and only the gradient norm is summed across ranks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.sharding import placement as pl

PIECE = 1 << 24


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (params, state), in place


def _split(*leaves):
    """Same-shaped tensors, each cut along its first dim into views of at
    most ``PIECE`` elements, zipped."""
    lead = leaves[0]
    if lead.ndim == 0 or lead.numel() <= PIECE:
        return [leaves]
    rows = max(1, PIECE // (lead.numel() // lead.shape[0]))
    return list(zip(*(t.split(rows) for t in leaves)))


def _pieces(*trees):
    """The leaves of same-structured trees (a DTensor's local shard), zipped,
    each cut into views of at most ``PIECE`` elements."""
    for leaves in zip(*(tree_leaves(t) for t in trees)):
        yield from _split(*(pl.local(t) for t in leaves))


def _f32_scalar(x) -> float:
    return float(torch.as_tensor(x, dtype=torch.float32))


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (lambda step: lr)


def _apply(p: torch.Tensor, upd: torch.Tensor) -> None:
    """p <- p - upd, computed in fp32 and rounded to p's dtype."""
    if p.dtype == torch.float32:
        p.sub_(upd)
    else:
        p.copy_(p.to(torch.float32).sub_(upd))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by min(1, max_norm / (||grads|| + 1e-9));
    returns ``(grads, global norm)``, the norm a 0-d fp32 tensor on the
    grads' device (no host sync)."""
    sq = sum(pl.sum_over_shards(sum(torch.sum(p.to(torch.float32) ** 2)
                                    for (p,) in _split(pl.local(g))), g)
             for g in tree_leaves(grads))
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        pl.local(g).mul_(scale.to(g.dtype))
    return grads, gnorm


def _zeros32(params):
    """fp32 zeros like each param (on a DTensor param's placements)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                               memory_format=torch.contiguous_format), params)


def adamw(lr: float | Callable, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: float | None = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": _zeros32(params), "nu": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        bc1, bc2 = _f32_scalar(1.0 - b1 ** t), _f32_scalar(1.0 - b2 ** t)
        lr_t = lr_fn(step)
        for p, g, m, v in _pieces(params, grads, state["mu"], state["nu"]):
            g32 = g.to(torch.float32)
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p.to(torch.float32), alpha=weight_decay)
            _apply(p, upd.mul_(lr_t))
        return params, state

    return Optimizer(init=init, update=update)


def sgd(lr: float | Callable, *, momentum: float = 0.9,
        grad_clip: float | None = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"vel": _zeros32(params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = lr_fn(step)
        for p, g, v in _pieces(params, grads, state["vel"]):
            v.mul_(momentum).add_(g.to(torch.float32))
            _apply(p, v * lr_t)
        return params, state

    return Optimizer(init=init, update=update)
