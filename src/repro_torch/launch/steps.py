"""Train step builder for one device (port of ``repro/launch/steps.py``).

    state   = init_train_state(cfg, optimizer)          # on the card
    step_fn = build_train_step(cfg, optimizer, microbatch=4)
    state, metrics = step_fn(state, batch)

The state is ``{params, opt_state, step}`` (+ ``grad_comp`` with binary
gradient compression): params and moments on the device, ``step`` a 0-d
int32 tensor on the host that the LR schedule reads.  A step takes
gradients of ``api.loss_fn`` with autograd (microbatches accumulated in
fp32, as the JAX package's scan does), optionally compresses them
(``core/compress.py``), and updates params and moments in place.  The JAX
package discards a step's new state when its loss is not finite
(``runtime/trainer.py``); an in-place update cannot be undone, so
``step_fn`` reads the loss on the host before it updates and, when it is not
finite, leaves the state as it was and reports ``skipped`` in the metrics.

No mesh: ``install_rules``, ``train_state_specs``, ``lower_train_step`` and
``lower_serve_step`` wait for ``distributed/`` and the dry-run tooling
(ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compress as gc
from repro_torch.models import api
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import Optimizer


def init_train_state(cfg: ArchConfig, optimizer: Optimizer, *, seed: int = 0,
                     device="cuda") -> dict:
    """Params drawn from a generator on ``device`` seeded with ``seed``,
    zero moments, step 0."""
    dev = resolve_device(device)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def loss_and_grads(fn, params, *args):
    """``jax.value_and_grad(fn, has_aux=True)`` for a params tree:
    ``fn(params, *args) -> (loss, metrics)`` gives ``(grads, metrics)``,
    the grads a tree like ``params`` in each param's dtype, the metrics
    detached.  The params are aliased by fresh leaves that require grad, so
    the caller's tensors never join the autograd graph."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = fn(live, *args)
    flat = tree_leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)}
    return tree_map(lambda p: by_id[id(p)], live), {k: v.detach() for k, v in metrics.items()}


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                     microbatch: int | None = None, grad_compress_M: int = 0):
    """Returns ``step_fn(state, batch) -> (state, metrics)``, the state
    updated in place.  ``microbatch`` > 1 splits the batch's rows into that
    many slices and averages their fp32 gradients and metrics."""

    def loss_fn(params, batch):
        return api.loss_fn(cfg, params, batch)

    def grads_of(params, batch):
        if not microbatch or microbatch <= 1:
            return loss_and_grads(loss_fn, params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} does not split into {microbatch} microbatches")
        mb = B // microbatch
        acc = met = None
        for i in range(microbatch):
            g, m = loss_and_grads(loss_fn, params, {k: v[i * mb:(i + 1) * mb]
                                                    for k, v in batch.items()})
            if acc is None:
                acc, met = tree_map(lambda t: t.to(torch.float32), g), m
            else:
                tree_map(lambda a, t: a.add_(t.to(torch.float32)), acc, g)
                met = {k: met[k] + m[k] for k in met}
        return (tree_map(lambda a: a.div_(microbatch), acc),
                {k: v / microbatch for k, v in met.items()})

    def step_fn(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        if not bool(torch.isfinite(metrics["loss"])):
            return state, dict(metrics, skipped=True)
        if grad_compress_M:
            grads, state["grad_comp"] = gc.compress_grads(grads, state["grad_comp"],
                                                          M=grad_compress_M)
        optimizer.update(grads, state["opt_state"], state["params"], state["step"])
        state["step"] = state["step"] + 1
        return state, dict(metrics, skipped=False)

    return step_fn
