"""Attention variants: GQA/MQA with qk-norm, RoPE and sliding window, and
MLA (port of ``repro/models/attention.py``).

Decode uses an explicit KV cache:
  * full attention: cache [B, S_max, kv, hd] with validity mask slot <= pos;
  * sliding window: rolling cache [B, W, kv, hd] + per-slot global
    positions (``slot_pos``), the new token written at ``pos % W``;
  * MLA: latent cache ``c_kv`` [B, S_max, kv_lora] and ``k_rope``
    [B, S_max, rope_dim]; decode uses the absorbed form (queries projected
    into latent space, in fp32).

The scores run in plain torch ops with fp32 accumulation, as the JAX
package's ``_gqa_scores`` does (no Pallas kernel there).  ``attn_decode``
and ``mla_decode`` write the new token's rows into the cache tensors in
place (JAX returns updated copies; on a DTensor cache each rank writes its
own shard, ``sharding/placement.write_rows``); the prefills build a fresh
cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.sharding import placement as pl

NEG_INF = -1e30


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache leaf (``jax.ShapeDtypeStruct``'s place)."""
    shape: tuple
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    hd = cfg.resolved_head_dim
    dt = cfg.torch_dtype
    dev = resolve_device(device)

    def lin(k, n, bias=False):
        return cm.init_linear(gen, k, n, dt, bias=bias, device=dev)

    p = {"wq": lin(cfg.d_model, cfg.n_heads * hd, cfg.qkv_bias),
         "wk": lin(cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias),
         "wv": lin(cfg.d_model, cfg.n_kv_heads * hd, cfg.qkv_bias),
         "wo": lin(cfg.n_heads * hd, cfg.d_model)}
    if cfg.qk_norm:
        p["q_norm"] = cm.init_rmsnorm(hd, dt, device=dev)
        p["k_norm"] = cm.init_rmsnorm(hd, dt, device=dev)
    return p


def split_heads(y, n_heads: int, head_dim: int):
    """A projection's output [B, S, n_heads * head_dim] -> [B, S, n_heads,
    head_dim].  A DTensor whose ``"model"`` axis does not divide
    ``n_heads`` is first made whole but for its batch rows
    (``placement.whole_rows``): DTensor cannot unflatten a dim whose split
    cuts a head (the JAX package's GSPMD reshards there)."""
    B, S, _ = y.shape
    if pl.is_dtensor(y) and n_heads % pl.model_size(y.device_mesh):
        y = pl.whole_rows(y)
    return y.reshape(B, S, n_heads, head_dim)


def _project_qkv(params, x, cfg: ArchConfig, positions):
    hd = cfg.resolved_head_dim
    q = split_heads(cm.linear(params["wq"], x, cfg.quant), cfg.n_heads, hd)
    k = split_heads(cm.linear(params["wk"], x, cfg.quant), cfg.n_kv_heads, hd)
    v = split_heads(cm.linear(params["wv"], x, cfg.quant), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = cm.rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k):
    """q [B,Sq,H,hd], k [B,Sk,kv,hd] -> logits [B, H, Sq, Sk], fp32 (operands
    widened to fp32: exact for bf16, so the sum is JAX's fp32 accumulation)."""
    B, Sq, H, hd = q.shape
    kv = k.shape[2]
    qr = q.reshape(B, Sq, kv, H // kv, hd).to(torch.float32)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qr, k.to(torch.float32))
    logits = logits / math.sqrt(hd)
    return logits.reshape(B, H, Sq, -1)


def _gqa_out(weights, v):
    """weights [B,H,Sq,Sk] (fp32), v [B,Sk,kv,hd] -> [B,Sq,H*hd] fp32; the
    weights are rounded to v's dtype first, as in the JAX package."""
    B, H, Sq, Sk = weights.shape
    kv = v.shape[2]
    w = weights.reshape(B, kv, H // kv, Sq, Sk).to(v.dtype).to(torch.float32)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return o.reshape(B, Sq, H * v.shape[-1])


def _attend(q, k, v, valid=None) -> torch.Tensor:
    """Softmax attention of q over k/v where ``valid`` (broadcast against
    [B, H, Sq, Sk]) is True, everywhere without it.  Over DTensors it runs
    on each rank's batch rows, every head whole (``placement.batch_local``)."""
    (q, k, v, valid), back = pl.batch_local(q, k, v, valid)
    logits = _gqa_scores(q, k)
    if valid is not None:
        logits = logits.masked_fill(~valid, NEG_INF)
    return back(_gqa_out(torch.softmax(logits, dim=-1), v))


def attn_forward(params, x, cfg: ArchConfig, *, positions=None, mask=None):
    """Full-sequence (train/prefill) attention.  x: [B, S, D].

    ``cfg.attn_chunk``: query-chunked evaluation; the S x S score tensor is
    never materialized whole.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    q = cm.shard(q, "batch", None, "heads", None)
    k = cm.shard(k, "batch", None, "kv_heads", None)
    v = cm.shard(v, "batch", None, "kv_heads", None)
    if mask is None:
        mask = cm.causal_mask(S, cfg.sliding_window, device=x.device)
    c = cfg.attn_chunk
    if c and S > c and S % c == 0:
        outs = []
        for i in range(S // c):
            k_hi = (i + 1) * c     # keys beyond the chunk's last query never attend
            outs.append(_attend(q[:, i * c: k_hi], k[:, :k_hi], v[:, :k_hi],
                                mask[None, None, i * c: k_hi, :k_hi]))
        o = torch.cat(outs, dim=1).to(x.dtype)
    else:
        o = _attend(q, k, v, mask[None, None]).to(x.dtype)
    # back on the residual's rows: under the sequence-sharded rules wo runs
    # on the rank's own sequence rows (a slice; a no-op otherwise)
    o = cm.shard(o, "batch", "seq", None)
    return cm.linear(params["wo"], o, cfg.quant)


# --- decode -----------------------------------------------------------------

def _cache_window(cfg: ArchConfig, max_len: int) -> int:
    """Cache rows per slot: the sliding window caps the rolling cache."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def attn_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    hd = cfg.resolved_head_dim
    W = _cache_window(cfg, max_len)
    kv = CacheSpec((batch, W, cfg.n_kv_heads, hd), cfg.torch_dtype)
    spec = {"k": kv, "v": kv}
    if cfg.sliding_window:
        spec["slot_pos"] = CacheSpec((batch, W), torch.int32)
    return spec


def init_from_specs(specs, device="cuda"):
    """Zeros for float leaves, -1 for int32 ones (empty ring slots)."""
    dev = resolve_device(device)
    return cm.tree_map(
        lambda s: torch.full(s.shape, -1 if s.dtype == torch.int32 else 0,
                             dtype=s.dtype, device=dev), specs)


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    return init_from_specs(attn_cache_specs(cfg, batch, max_len), device)


def attn_prefill(params, x, cfg: ArchConfig, *, max_len: int, positions=None, mask=None):
    """Full-sequence attention that also emits the decode-cache state.

    x: [B, S, D] -> (y [B, S, D], cache leaf shaped like
    ``attn_cache_specs(cfg, B, max_len)``) with k/v for positions 0..S-1
    written.  Requires S <= max_len.  For sliding-window caches only the
    last ``W`` tokens are written, at their rolling slots ``pos % W`` with
    ``slot_pos`` bookkeeping matching token-wise decode.
    """
    B, S, _ = x.shape
    dev = x.device
    if positions is None:
        positions = torch.arange(S, device=dev)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    if mask is None:
        mask = cm.causal_mask(S, cfg.sliding_window, device=dev)
    o = _attend(q, k, v, mask[None, None]).to(x.dtype)
    y = cm.linear(params["wo"], o, cfg.quant)

    W = _cache_window(cfg, max_len)
    dt = cfg.torch_dtype
    ck = torch.zeros((B, W, cfg.n_kv_heads, k.shape[-1]), dtype=dt, device=dev)
    cv = torch.zeros_like(ck)
    cache = {"k": ck, "v": cv}
    if cfg.sliding_window:
        n = min(S, W)
        ts = torch.arange(S - n, S, device=dev)
        slots = ts % W
        ck[:, slots] = k[:, S - n:].to(dt)
        cv[:, slots] = v[:, S - n:].to(dt)
        slot_pos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
        slot_pos[:, slots] = ts.to(torch.int32).expand(B, n)
        cache["slot_pos"] = slot_pos
    else:
        ck[:, :S] = k.to(dt)
        cv[:, :S] = v.to(dt)
    return y, cache


def attn_decode(params, x, cfg: ArchConfig, cache: dict, pos: torch.Tensor):
    """One-token decode.  x: [B, 1, D], pos: [B] int -> (y, cache), the
    cache's rows at each slot's position written in place."""
    q, k, v = _project_qkv(params, x, cfg, pos[:, None])
    W = cache["k"].shape[1]
    slot = (pos % W) if cfg.sliding_window else pos
    pl.write_rows(cache["k"], slot, k[:, 0])
    pl.write_rows(cache["v"], slot, v[:, 0])
    if cfg.sliding_window:
        slot_pos = cache["slot_pos"]
        pl.write_rows(slot_pos, slot, pos.to(torch.int32))
        p = pos[:, None]
        valid = (slot_pos >= 0) & (slot_pos <= p) & (p - slot_pos < cfg.sliding_window)
    else:
        valid = torch.arange(W, device=x.device)[None, :] <= pos[:, None]
    o = _attend(q, cache["k"], cache["v"], valid[:, None, None, :]).to(x.dtype)
    return cm.linear(params["wo"], o, cfg.quant), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    H, qk, r, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    def lin(k, n):
        return cm.init_linear(gen, k, n, dt, device=dev)

    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = lin(cfg.d_model, cfg.q_lora_rank)
        p["q_norm"] = cm.init_rmsnorm(cfg.q_lora_rank, dt, device=dev)
        p["wuq"] = lin(cfg.q_lora_rank, H * (qk + r))
    else:
        p["wq"] = lin(cfg.d_model, H * (qk + r))
    p["wdkv"] = lin(cfg.d_model, cfg.kv_lora_rank + r)
    p["kv_norm"] = cm.init_rmsnorm(cfg.kv_lora_rank, dt, device=dev)
    p["wuk"] = lin(cfg.kv_lora_rank, H * qk)
    p["wuv"] = lin(cfg.kv_lora_rank, H * vd)
    p["wo"] = lin(H * vd, cfg.d_model)
    return p


def _mla_queries(params, x, cfg: ArchConfig, positions):
    H, qk, r = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = cm.rms_norm(params["q_norm"], cm.linear(params["wdq"], x, cfg.quant),
                         cfg.norm_eps)
        q = cm.linear(params["wuq"], cq, cfg.quant)
    else:
        q = cm.linear(params["wq"], x, cfg.quant)
    q = split_heads(q, H, qk + r)
    return q[..., :qk], cm.apply_rope(q[..., qk:], positions, cfg.rope_theta)


def _mla_latents(params, x, cfg: ArchConfig, positions):
    """c_kv [B,S,rank] (normed), k_rope [B,S,r] (shared across heads)."""
    rank = cfg.kv_lora_rank
    dkv = cm.linear(params["wdkv"], x, cfg.quant)
    c_kv = cm.rms_norm(params["kv_norm"], dkv[..., :rank], cfg.norm_eps)
    k_rope = cm.apply_rope(dkv[..., rank:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_attend(params, x, cfg: ArchConfig, positions, mask):
    """Materialized per-head k/v from the latents -> (y [B,S,D], c_kv, k_rope).
    Operands are widened to fp32 (JAX's fp32 accumulation); the softmax
    weights are rounded to x's dtype before the value product."""
    B, S, _ = x.shape
    H, qk, r, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_queries(params, x, cfg, positions)
    c_kv, k_rope = _mla_latents(params, x, cfg, positions)
    k_nope = split_heads(cm.linear(params["wuk"], c_kv, cfg.quant), H, qk)
    v = split_heads(cm.linear(params["wuv"], c_kv, cfg.quant), H, vd)
    (qn, qr, kn, kr, vl), back = pl.batch_local(q_nope, q_rope, k_nope, k_rope, v)
    f32 = torch.float32
    logits = (torch.einsum("bqhd,bshd->bhqs", qn.to(f32), kn.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", qr.to(f32), kr.to(f32))) \
        * (1.0 / math.sqrt(qk + r))
    if mask is None:
        mask = cm.causal_mask(S, device=x.device)
    w = torch.softmax(logits.masked_fill(~mask[None, None], NEG_INF), dim=-1).to(x.dtype)
    o = torch.einsum("bhqs,bshd->bqhd", w.to(f32), vl.to(f32))
    o = cm.shard(back(o.reshape(o.shape[0], S, H * vd).to(x.dtype)), "batch", "seq", None)
    return cm.linear(params["wo"], o, cfg.quant), c_kv, k_rope


def mla_forward(params, x, cfg: ArchConfig, *, positions=None, mask=None):
    """Train/prefill MLA: materialize per-head k/v from the latent."""
    return _mla_attend(params, x, cfg, positions, mask)[0]


def mla_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    dt = cfg.torch_dtype
    return {"c_kv": CacheSpec((batch, max_len, cfg.kv_lora_rank), dt),
            "k_rope": CacheSpec((batch, max_len, cfg.qk_rope_dim), dt)}


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    return init_from_specs(mla_cache_specs(cfg, batch, max_len), device)


def mla_prefill(params, x, cfg: ArchConfig, *, max_len: int, positions=None, mask=None):
    """Full-sequence MLA that also emits the latent decode cache: the
    per-position ``c_kv``/``k_rope`` for 0..S-1, zero-padded to
    ``max_len``.  Requires S <= max_len."""
    B, S, _ = x.shape
    y, c_kv, k_rope = _mla_attend(params, x, cfg, positions, mask)
    dt = cfg.torch_dtype
    cache = {"c_kv": torch.zeros((B, max_len, cfg.kv_lora_rank), dtype=dt, device=x.device),
             "k_rope": torch.zeros((B, max_len, cfg.qk_rope_dim), dtype=dt, device=x.device)}
    cache["c_kv"][:, :S] = c_kv.to(dt)
    cache["k_rope"][:, :S] = k_rope.to(dt)
    return y, cache


def mla_decode(params, x, cfg: ArchConfig, cache: dict, pos: torch.Tensor):
    """Absorbed-form decode: scores and outputs computed in latent space, in
    fp32, so the per-token cache is kv_lora_rank + rope_dim values.  The
    new token's latents are written into the cache in place; ``wuk``/``wuv``
    are read as fp weights (they stay fp in a binarized tree)."""
    B = x.shape[0]
    H, qk, r, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rank = cfg.kv_lora_rank
    f32 = torch.float32
    q_nope, q_rope = _mla_queries(params, x, cfg, pos[:, None])     # [B,1,H,*]
    c_new, k_rope_new = _mla_latents(params, x, cfg, pos[:, None])
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    pl.write_rows(c_kv, pos, c_new[:, 0])
    pl.write_rows(k_rope, pos, k_rope_new[:, 0])
    # absorb W_uk into the query:  q_lat[b,h,rank] = q_nope · W_uk[rank, h, qk]
    wuk = params["wuk"]["w"].to(f32).reshape(rank, H, qk)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), wuk)
    ckv = c_kv.to(f32)
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32), k_rope.to(f32))) \
        * (1.0 / math.sqrt(qk + r))
    valid = torch.arange(c_kv.shape[1], device=x.device)[None, :] <= pos[:, None]
    w = torch.softmax(logits.masked_fill(~valid[:, None, :], NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", w, ckv)
    wuv = params["wuv"]["w"].to(f32).reshape(rank, H, vd)
    o = torch.einsum("bhr,rhd->bhd", o_lat, wuv).reshape(B, 1, H * vd)
    return cm.linear(params["wo"], o.to(x.dtype), cfg.quant), cache
