"""Mixture-of-Experts with index-based dispatch (port of ``repro/models/moe.py``).

Dispatch is index-based (no [T, E, C] one-hot) and *batch-blocked*: each
batch row (sequence) dispatches its own tokens to per-expert capacity
slots.  Tokens beyond capacity are dropped (GShard-style); capacity goes to
the picks in token-major, k-minor order, so earlier tokens win it.

Decode (S == 1) instead dispatches globally across the token batch, so
per-expert capacity stays ~top_k·B/E instead of one slot per (row, expert).

The router runs in fp32 whatever the activations' dtype.  The routed
expert banks (``w_gate``/``w_up``/``w_down``, ``[E, D, F]``) are plain fp
tensors, not ``{w}`` linears: ``binarize_model_params`` passes over them
and their products are plain ``einsum``s (fake-quant runs Algorithm 2 per
expert, as the JAX package's ``vmap`` does).  The shared expert is an
``ffn`` of ``{w}`` linears and so goes on the binary matmul kernel.  Over
a mesh (a DTensor x) :func:`_moe_ffn_mesh` routes on plain tensors and
runs the expert products on each rank's shards of the banks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import binarize as bz
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.sharding import placement as pl


def init_moe(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    E, D = cfg.n_experts, cfg.d_model
    Fe = cfg.d_ff_expert or cfg.d_ff

    def draw(shape, scale, dtype):
        # scaled in place: a full-width bank is 15 GB in fp32
        w = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
        return w.to(device=dev, dtype=dtype)

    p = {"router": {"w": draw((D, E), 1.0 / math.sqrt(D), torch.float32)},
         "w_gate": draw((E, D, Fe), 1.0 / math.sqrt(D), dt),
         "w_up": draw((E, D, Fe), 1.0 / math.sqrt(D), dt),
         "w_down": draw((E, Fe, D), 1.0 / math.sqrt(Fe), dt)}
    if cfg.n_shared_experts:
        p["shared"] = ffn_mod.init_ffn(gen, cfg, d_ff=Fe * cfg.n_shared_experts, device=dev)
    return p


def _dispatch_indices(expert_ids: torch.Tensor, E: int, capacity: int):
    """expert_ids: [T, k] -> (dispatch [E, C] token-row indices, sentinel T;
    slot [T, k]: position inside the expert, -1 if dropped).

    A pick past capacity is written to a spare column C and sliced off (the
    JAX package's ``mode="drop"``): no out-of-range index reaches the
    device and no mask is read on the host."""
    T, k = expert_ids.shape
    flat = expert_ids.reshape(-1)                                   # [T*k]
    onehot = F.one_hot(flat, E)                                     # [T*k, E]
    ranks = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.sum(ranks * onehot, dim=1)                         # [T*k]
    ok = slot < capacity
    token_row = torch.arange(T * k, device=flat.device) // k
    dispatch = torch.full((E, capacity + 1), T, dtype=torch.long, device=flat.device)
    dispatch[flat, torch.where(ok, slot, capacity)] = torch.where(ok, token_row, T)
    return dispatch[:, :capacity], torch.where(ok, slot, -1).reshape(T, k)


def _expert_weights(params, cfg: ArchConfig, dtype):
    q = cfg.quant
    if q.mode == "fake_quant":
        def binz(w):
            return torch.stack([bz.fake_quant(we.to(torch.float32), q.M,
                                              algorithm=q.algorithm, K_iters=q.K_iters,
                                              group_size=q.group_size)
                                for we in w.unbind(0)]).to(dtype)

        return binz(params["w_gate"]), binz(params["w_up"]), binz(params["w_down"])
    return params["w_gate"], params["w_up"], params["w_down"]


def route(params, x: torch.Tensor, cfg: ArchConfig):
    """The router of :func:`moe_ffn`: x [B, S, D] -> (probs [G, Sg, E],
    normalized gate values and expert ids [G, Sg, k]), in fp32, with the
    group layout G, Sg = B, S for sequences and 1, B for decode."""
    B, S, D = x.shape
    G, Sg = (1, B) if S == 1 else (B, S)
    logits = torch.einsum("gsd,de->gse", x.reshape(G, Sg, D).to(torch.float32),
                          params["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), expert_ids


def _dispatch(expert_ids: torch.Tensor, E: int, capacity: int):
    """:func:`_dispatch_indices` per group: expert ids [G, Sg, k] ->
    (dispatch [G, E, C], slot [G, Sg, k])."""
    pairs = [_dispatch_indices(ids, E, capacity) for ids in expert_ids.unbind(0)]
    return torch.stack([d for d, _ in pairs]), torch.stack([s for _, s in pairs])


def _experts(xg: torch.Tensor, dispatch: torch.Tensor, banks: dict, cfg: ArchConfig):
    """The grouped expert products: xg [G, Sg, D], the token rows of some
    experts ``dispatch`` [G, E', C] and those experts' banks -> [G, E', C, D]."""
    G, _, D = xg.shape
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    gidx = torch.arange(G, device=xg.device)
    expert_in = x_pad[gidx[:, None, None], dispatch]                # [G, E', C, D]
    w_gate, w_up, w_down = _expert_weights(banks, cfg, xg.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate)) \
        * torch.einsum("gecd,edf->gecf", expert_in, w_up)
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _combine(expert_out: torch.Tensor, expert_ids: torch.Tensor, slot: torch.Tensor,
             gate_vals: torch.Tensor) -> torch.Tensor:
    """Each pick's expert output [G, E, C, D] times its gate, summed over
    the k picks: [G, Sg, D]; a dropped pick adds nothing."""
    G, _, C, _ = expert_out.shape
    gidx = torch.arange(G, device=expert_out.device)
    gathered = expert_out[gidx[:, None, None], expert_ids,
                          torch.clamp(slot, 0, C - 1)]              # [G, Sg, k, D]
    return torch.sum(torch.where((slot >= 0)[..., None], gathered, 0.0)
                     * gate_vals[..., None].to(gathered.dtype), dim=2)


def _aux(probs, expert_ids, slot, E: int, whole=lambda t: t) -> dict:
    """The load-balance loss (Switch-style) and the dropped share, over the
    tensors ``whole`` makes of each [G, Sg, ...] one."""
    frac_tokens = torch.mean(whole(F.one_hot(expert_ids[..., 0], E).to(torch.float32)),
                             dim=(0, 1))
    frac_probs = torch.mean(whole(probs), dim=(0, 1))
    return {"load_balance_loss": E * torch.sum(frac_tokens * frac_probs),
            "dropped_frac": 1.0 - torch.mean(whole((slot >= 0).to(torch.float32)))}


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig):
    """x: [B, S, D] -> (y, aux metrics)."""
    if pl.is_dtensor(x):
        return _moe_ffn_mesh(params, x, cfg)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    # group layout: per-row dispatch for sequences, global for decode
    G, Sg = (1, B) if S == 1 else (B, S)
    xg = x.reshape(G, Sg, D)
    probs, gate_vals, expert_ids = route(params, x, cfg)            # [G, Sg, k]
    capacity = max(1, int(cfg.capacity_factor * Sg * k / E))
    dispatch, slot = _dispatch(expert_ids, E, capacity)
    y = _combine(_experts(xg, dispatch, params, cfg), expert_ids, slot, gate_vals)
    if cfg.n_shared_experts:
        y = y + ffn_mod.ffn_forward(params["shared"], xg, cfg).to(y.dtype)
    return y.reshape(B, S, D).to(x.dtype), _aux(probs, expert_ids, slot, E)


def _moe_ffn_mesh(params, x, cfg: ArchConfig):
    """:func:`moe_ffn` over a DTensor x (a mesh).  Routing, dispatch and
    combine run on plain tensors, so no index write meets a DTensor: a
    decode's global dispatch on every row, made whole on each rank; a
    sequence's on the rows of the rank's data coordinate (its groups are
    its own rows).  The expert products run on each rank's local shards, as
    the JAX rule places the banks (``rules._param_rules``): with the
    experts split on ``"model"`` (expert parallel) each rank takes the
    tokens of its own experts and all-gathers every expert's output for its
    rows; with the hidden dim split there (grok's 8 experts on a 16-wide
    axis) each rank computes a partial sum over its hidden columns, summed
    over ``"model"``.  The banks' FSDP dim is gathered over the data axes
    first.  (DTensor's own einsum over these placements makes shards that
    split unevenly, whose local views it then cannot take.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G, Sg = (1, B) if S == 1 else (B, S)
    if S == 1:
        xr = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    else:
        xr = pl.whole_rows(x, batch_only=True)   # a group is a whole sequence
    rows = tuple(p if isinstance(p, Shard) else Replicate() for p in xr.placements)
    xl = xr.to_local()
    xg = xl.reshape(-1, Sg, D)                                      # [G_local, Sg, D]
    probs, gate_vals, expert_ids = route({"router": {"w": pl.full(params["router"]["w"])}},
                                         xl, cfg)
    capacity = max(1, int(cfg.capacity_factor * Sg * k / E))
    dispatch, slot = _dispatch(expert_ids, E, capacity)             # [G_local, E, C]
    (wg, on_model), (wu, _), (wd, _) = (pl.model_local(params[n])
                                        for n in ("w_gate", "w_up", "w_down"))
    split_experts = isinstance(on_model, Shard) and on_model.dim == 0
    split_hidden = isinstance(on_model, Shard) and on_model.dim == 2
    m = pl.model_dim(mesh)
    shape = (G, E, capacity, D)

    def with_model(p):
        return tuple(p if i == m else r for i, r in enumerate(rows))

    local_shape, offset = compute_local_shape_and_global_offset(
        shape, mesh, with_model(Shard(1) if split_experts else Replicate()))
    mine = dispatch[:, offset[1]: offset[1] + local_shape[1]]       # the rank's experts
    part = _experts(xg, mine, {"w_gate": wg, "w_up": wu, "w_down": wd}, cfg)
    placed = with_model(Shard(1) if split_experts else Partial() if split_hidden
                        else Replicate())
    out = pl.from_local(part, mesh, placed, shape).redistribute(mesh, rows).to_local()
    y = _combine(out, expert_ids, slot, gate_vals)
    y = pl.from_local(y.reshape(xl.shape).to(x.dtype), mesh, rows, (B, S, D))
    if cfg.n_shared_experts:
        y = y + ffn_mod.ffn_forward(params["shared"], x, cfg).to(y.dtype)
    # aux over the global batch: each rank's rows as a DTensor, then the mean
    return y, _aux(probs, expert_ids, slot, E,
                   lambda t: pl.from_local(t, mesh, rows, (G, Sg) + tuple(t.shape[2:])))
