"""Train and serve step builders, on one device or on a mesh (port of
``repro/launch/steps.py``).

    state   = init_train_state(cfg, optimizer)                 # on the card
    step_fn = build_train_step(cfg, optimizer, microbatch=4)
    state, metrics = step_fn(state, batch)

    state   = init_train_state(cfg, optimizer, mesh=mesh)      # sharded
    step_fn = build_train_step(cfg, optimizer, mesh=mesh)

    serve = build_serve_step(cfg, mesh, kind="decode")
    params = serve.shard_params(packed)
    logits, cache = serve(params, serve.shard_batch({"tokens", "pos", "cache"}))

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

On a mesh (a ``DeviceMesh`` with axes ``data`` (and ``pod``) and
``model``) the JAX package's shardings become DTensor placements: params and
moments are DTensors placed by ``sharding/rules.param_pspecs`` (FSDP + TP),
each batch is placed by ``batch_pspecs`` (rows over the data axes), the
activations follow the logical-axis rules ``install_rules`` sets, the
gradients land on their params' placements (a reduction over the data
axes: the mean over the global batch), and the update runs on each rank's
shard.  Every rank calls the step with the same global batch.  With
``grad_compress_M`` the error state (``grad_comp``) sits on the params'
placements and the compression runs on each rank's shards, its alphas
global means (``core/compress.py``).  With ``seq_sharded`` the rules put
the sequence on ``"data"`` (the JAX package's sequence parallelism for a
batch that does not divide the data axes): the tokens, the residual stream
and every linear's rows are split on the sequence, attention gathers it
whole; a batch that does divide them names ``"data"`` twice in the
residual's constraint, which ``placement.spec_placements`` refuses with a
``ValueError``, as JAX refuses it.

The dry run's entries, ``lower_train_step`` and ``lower_serve_step``, build
the state (from ``api.param_shapes``, placed by ``param_pspecs``, and
``optimizer.init`` over it) and the batch as ``meta`` DTensors on a mesh
over a fake process group, and return a ``cost_analysis.Lowered``: its
``compile()`` runs the same step once under a ``CostCounter``.  The
lowered train step leaves out the host read of the loss, as the JAX
package's lowered step has none.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compress as gc
from repro_torch.launch import cost_analysis
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import Optimizer
from repro_torch.sharding import placement as pl
from repro_torch.sharding import rules as shr


def install_rules(cfg: ArchConfig, mesh, *, seq_sharded: bool = False) -> None:
    cm.set_axis_rules(shr.activation_rules(mesh, seq_sharded=seq_sharded),
                      shr.axis_sizes(mesh))


def train_state_specs(cfg: ArchConfig, mesh, optimizer: Optimizer, *,
                      grad_compress_M: int = 0) -> dict:
    """PartitionSpec tree for {params, opt_state, step} (FSDP+TP), and
    ``grad_comp`` (the params' specs) with ``grad_compress_M``; ``mesh`` a
    DeviceMesh or ``{axis: size}``."""
    param_shapes = api.param_shapes(cfg)
    pspecs = shr.param_pspecs(cfg, param_shapes, mesh)
    # optimizer state mirrors the param tree per moment buffer
    out = {"params": pspecs, "opt_state": {k: pspecs for k in optimizer.init(param_shapes)},
           "step": shr.P()}
    if grad_compress_M:
        out["grad_comp"] = gc.CompressionState(error=pspecs)
    return out


def train_state_shardings(cfg: ArchConfig, mesh, optimizer: Optimizer, *,
                          grad_compress_M: int = 0) -> dict:
    """The ``NamedSharding`` of every param, moment (and error leaf, with
    ``grad_compress_M``), None for the host ``step``: what
    ``CheckpointManager.restore(shardings=)`` and ``Trainer(state_shardings=)``
    take."""
    specs = train_state_specs(cfg, mesh, optimizer, grad_compress_M=grad_compress_M)
    out = {"params": shr.param_placements(specs["params"], mesh),
           "opt_state": shr.param_placements(specs["opt_state"], mesh), "step": None}
    if grad_compress_M:
        out["grad_comp"] = gc.CompressionState(
            error=shr.param_placements(specs["grad_comp"].error, mesh))
    return out


def init_train_state(cfg: ArchConfig, optimizer: Optimizer, *, seed: int = 0,
                     device="cuda", mesh=None) -> dict:
    """Params drawn from a generator on ``device`` seeded with ``seed``,
    zero moments, step 0.  With ``mesh`` every rank draws the same params
    and keeps its shards; the moments are made on those shards."""
    dev = resolve_device(device)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    if mesh is not None:
        params = shr.distribute_params(params, train_state_specs(cfg, mesh, optimizer)["params"],
                                       mesh)
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


def shard_batch(cfg: ArchConfig, batch: dict, mesh, *, seq_sharded: bool = False) -> dict:
    """A global batch (the same on every rank) placed by ``batch_pspecs``."""
    return shr.distribute_params(
        batch, shr.batch_pspecs(cfg, batch, mesh, seq_sharded=seq_sharded), mesh)


def _grads_fn(cfg: ArchConfig, microbatch: int | None, mesh, seq_sharded: bool = False):
    """``grads_of(params, batch) -> (grads, metrics)`` of the train step."""
    def loss_fn(params, batch):
        return api.loss_fn(cfg, params, batch)

    def one(params, batch):
        if mesh is None:
            return loss_and_grads(loss_fn, params, batch)
        # forward and backward over DTensors (the plain tensors the model
        # makes, masks and positions, join as replicated); each gradient
        # moved to its param's placements, the metrics gathered whole
        install_rules(cfg, mesh, seq_sharded=seq_sharded)
        with implicit_replication():
            grads, metrics = loss_and_grads(loss_fn, params,
                                            shard_batch(cfg, batch, mesh, seq_sharded=seq_sharded))
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                             if pl.is_dtensor(p) else g, grads, params)
        return grads, {k: pl.full(v) for k, v in metrics.items()}

    def grads_of(params, batch):
        if not microbatch or microbatch <= 1:
            return one(params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} does not split into {microbatch} microbatches")
        mb = B // microbatch
        acc = met = None
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            g, m = one(params, part)
            if acc is None:
                acc, met = tree_map(lambda t: t.to(torch.float32), g), m
            else:
                tree_map(lambda a, t: a.add_(t.to(torch.float32)), acc, g)
                met = {k: met[k] + m[k] for k in met}
        return (tree_map(lambda a: a.div_(microbatch), acc),
                {k: v / microbatch for k, v in met.items()})

    return grads_of


def _update(optimizer: Optimizer, state: dict, grads, grad_compress_M: int = 0) -> None:
    """The train step's update of ``state`` in place."""
    if grad_compress_M:
        grads, state["grad_comp"] = gc.compress_grads(grads, state["grad_comp"],
                                                      M=grad_compress_M)
    optimizer.update(grads, state["opt_state"], state["params"], state["step"])
    state["step"] = state["step"] + 1


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                     microbatch: int | None = None, grad_compress_M: int = 0, mesh=None,
                     seq_sharded: bool = False):
    """Returns ``step_fn(state, batch) -> (state, metrics)``, the state
    updated in place.  ``microbatch`` > 1 splits the batch's rows into that
    many slices and averages their fp32 gradients and metrics.
    ``grad_compress_M`` > 0 compresses the gradients first; the state then
    holds ``grad_comp`` (``core.compress.init_state(state["params"])``).
    With ``mesh`` the state is ``init_train_state(..., mesh=mesh)``'s and
    the batch the global one; ``seq_sharded`` installs the
    sequence-sharded rules."""
    grads_of = _grads_fn(cfg, microbatch, mesh, seq_sharded)

    def step_fn(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        if not bool(torch.isfinite(metrics["loss"])):
            return state, dict(metrics, skipped=True)
        _update(optimizer, state, grads, grad_compress_M)
        return state, dict(metrics, skipped=False)

    return step_fn


def lower_train_step(cfg: ArchConfig, mesh, optimizer: Optimizer, batch_specs, *,
                     microbatch: int | None = None, seq_sharded: bool = False):
    """Dry-run entry: the mesh train step over ``meta`` DTensors (the
    state from ``api.param_shapes``, FSDP+TP, and ``optimizer.init`` over
    it; ``batch_specs`` the global batch of ``configs/base.input_specs``),
    as a ``cost_analysis.Lowered``.  ``microbatch`` > 1 accumulates
    gradients over slices of the batch, as ``build_train_step`` does;
    ``seq_sharded`` installs the sequence-sharded rules."""
    specs = train_state_specs(cfg, mesh, optimizer)
    params = shr.distribute_params(api.param_shapes(cfg), specs["params"], mesh)
    state = {"params": params, "opt_state": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    grads_of = _grads_fn(cfg, microbatch, mesh, seq_sharded)

    def step_fn(state, batch):
        grads, metrics = grads_of(state["params"], batch)
        _update(optimizer, state, grads)
        return state, metrics

    return cost_analysis.Lowered(step_fn, (state, batch_specs), cost_analysis.local_bytes(
        (state, shard_batch(cfg, batch_specs, mesh, seq_sharded=seq_sharded))))


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

class ServeStep:
    """One decode or prefill step of ``cfg`` on ``mesh``: what the JAX
    package's ``lower_serve_step`` lowers, run eagerly over DTensors.

    ``shard_params`` places a params tree (the packed tree when
    ``cfg.quant.mode == "binary"``) by ``param_pspecs``, FSDP over the data
    axes or, with ``fsdp_params=False``, TP-only; ``shard_batch`` places
    ``{tokens, pos, cache}`` (decode) or ``{tokens}`` (prefill) by
    ``batch_pspecs`` (with ``seq_sharded``, the sequence split on
    ``"data"`` where the batch does not divide the data axes).  Calling it
    runs ``api.decode_step`` -> (logits, cache), the cache written in place
    on each rank's shard, or ``api.forward`` -> logits; the logits are a
    DTensor split on ``"vocab"``.  Every binary linear runs the kernel on
    the rank's column shard (``core/binlinear.py``)."""

    def __init__(self, cfg: ArchConfig, mesh, kind: str, fsdp_params: bool,
                 seq_sharded: bool = False):
        if kind not in ("decode", "prefill"):
            raise ValueError(f"unknown serve step kind {kind!r}")
        self.cfg, self.mesh, self.kind, self.fsdp_params = cfg, mesh, kind, fsdp_params
        self.seq_sharded = seq_sharded

    def shard_params(self, params):
        specs = shr.param_pspecs(self.cfg, params, self.mesh, fsdp=self.fsdp_params)
        return shr.distribute_params(params, specs, self.mesh)

    def shard_batch(self, batch: dict) -> dict:
        return shard_batch(self.cfg, batch, self.mesh, seq_sharded=self.seq_sharded)

    @torch.no_grad()
    def __call__(self, params, batch):
        install_rules(self.cfg, self.mesh, seq_sharded=self.seq_sharded)
        with implicit_replication():
            if self.kind == "decode":
                return api.decode_step(self.cfg, params, batch)
            return api.forward(self.cfg, params, batch)[0]


def build_serve_step(cfg: ArchConfig, mesh, *, kind: str = "decode",
                     fsdp_params: bool | None = None, seq_sharded: bool = False) -> ServeStep:
    """The serve step of ``cfg`` on ``mesh``; ``fsdp_params`` defaults to
    ``cfg.serve_fsdp``."""
    return ServeStep(cfg, mesh, kind, cfg.serve_fsdp if fsdp_params is None else fsdp_params,
                     seq_sharded)


def lower_serve_step(cfg: ArchConfig, mesh, batch_specs, *, kind: str = "decode",
                     seq_sharded: bool = False, fsdp_params: bool = True):
    """Dry-run entry for decode/prefill steps: ``build_serve_step``'s step
    over ``meta`` DTensors, as a ``cost_analysis.Lowered``.

    ``cfg.quant.mode == 'binary'`` lowers over the PACKED parameter tree
    (``api.param_shapes(cfg, qc=cfg.quant)``, the paper's deployment form),
    each binary linear through ``binary_matmul``'s meta route.
    ``fsdp_params=False`` shards params TP-only (replicated over the DP
    axes); ``seq_sharded`` installs the sequence-sharded rules."""
    step = build_serve_step(cfg, mesh, kind=kind, fsdp_params=fsdp_params,
                            seq_sharded=seq_sharded)
    qc = cfg.quant if cfg.quant.mode == "binary" else None
    params = step.shard_params(api.param_shapes(cfg, qc=qc))
    batch = step.shard_batch(batch_specs)
    return cost_analysis.Lowered(step, (params, batch),
                                 cost_analysis.local_bytes((params, batch)))
