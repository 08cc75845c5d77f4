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
``ffn`` of ``{w}`` linears and so goes on the binary matmul kernel.  The
expert inputs and hidden states carry the JAX package's expert-parallel
``shard`` constraints (``"experts"`` on ``"model"``), which act on a mesh.
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


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig):
    """x: [B, S, D] -> (y, aux metrics)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    # group layout: per-row dispatch for sequences, global for decode
    G, Sg = (1, B) if S == 1 else (B, S)
    xg = x.reshape(G, Sg, D)
    probs, gate_vals, expert_ids = route(params, x, cfg)            # [G, Sg, k]
    # --- dispatch (per group) ---
    capacity = max(1, int(cfg.capacity_factor * Sg * k / E))
    pairs = [_dispatch_indices(ids, E, capacity) for ids in expert_ids.unbind(0)]
    dispatch = torch.stack([d for d, _ in pairs])                   # [G, E, C]
    slot = torch.stack([s for _, s in pairs])                       # [G, Sg, k]
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    gidx = torch.arange(G, device=x.device)
    expert_in = x_pad[gidx[:, None, None], dispatch]                # [G, E, C, D]
    expert_in = cm.shard(expert_in, "batch", "experts", None, None)
    # --- expert computation (grouped products) ---
    w_gate, w_up, w_down = _expert_weights(params, cfg, x.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate)) \
        * torch.einsum("gecd,edf->gecf", expert_in, w_up)
    h = cm.shard(h, "batch", "experts", None, None)
    expert_out = torch.einsum("gecf,efd->gecd", h, w_down)         # [G, E, C, D]
    # --- combine ---
    ok = slot >= 0
    gathered = expert_out[gidx[:, None, None], expert_ids,
                          torch.clamp(slot, 0, capacity - 1)]       # [G, Sg, k, D]
    y = torch.sum(torch.where(ok[..., None], gathered, 0.0)
                  * gate_vals[..., None].to(gathered.dtype), dim=2)
    if cfg.n_shared_experts:
        y = y + ffn_mod.ffn_forward(params["shared"], xg, cfg).to(y.dtype)
    # --- aux: load-balance loss (Switch-style) ---
    frac_tokens = torch.mean(F.one_hot(expert_ids[..., 0], E).to(torch.float32), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = {"load_balance_loss": E * torch.sum(frac_tokens * frac_probs),
           "dropped_frac": 1.0 - torch.mean(ok.to(torch.float32))}
    return y.reshape(B, S, D).to(x.dtype), aux
