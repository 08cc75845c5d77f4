"""Whisper-style encoder-decoder backbone (port of ``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the JAX package: ``frame_embeds``
([B, T_enc, D], precomputed) arrive as inputs.  Encoder: bidirectional
self-attention with fixed sinusoidal positions added to the input (and the
attention's RoPE at ``arange(T_enc)``, as the reference has both).
Decoder: causal self-attention, then cross-attention to the encoder output
(no mask, no RoPE).  Decode caches the decoder self-KV, written in place by
``attn_decode``, and the static cross K/V of every decoder layer.

As in the JAX package, none of these walks resolves a per-layer §IV-D
schedule: every layer runs ``cfg.quant`` as it is (``m_active``, or all M
levels), whatever ``m_schedule`` says.  Layer params are stacked ``[L, ...]``
under the reference's names, so a JAX tree crosses over as it is.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod


def init_enc_layer(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    return {"ln1": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "ln2": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "attn": attn.init_attn(gen, cfg, device=dev),
            "ffn": ffn_mod.init_ffn(gen, cfg, device=dev)}


def init_dec_layer(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """A decoder layer; its cross-attention ``xattn`` has the projections
    of a self-attention."""
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    return {"ln1": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "ln_x": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "ln2": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "attn": attn.init_attn(gen, cfg, device=dev),
            "xattn": attn.init_attn(gen, cfg, device=dev),
            "ffn": ffn_mod.init_ffn(gen, cfg, device=dev)}


def init_encdec(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    return {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev),
            "enc_layers": cm.stack_trees([init_enc_layer(gen, cfg, device=dev)
                                          for _ in range(cfg.n_encoder_layers)]),
            "enc_norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "dec_layers": cm.stack_trees([init_dec_layer(gen, cfg, device=dev)
                                          for _ in range(cfg.n_layers)]),
            "final_norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev)}


def _n_layers(stacked) -> int:
    return stacked["ln1"]["scale"].shape[0]


def _cross_attend(params, x, enc_kv, cfg: ArchConfig):
    """x: [B, Sq, D] queries; enc_kv = (k, v): [B, Se, kv, hd]."""
    q = attn.split_heads(cm.linear(params["wq"], x, cfg.quant), cfg.n_heads,
                         cfg.resolved_head_dim)
    k, v = enc_kv
    return cm.linear(params["wo"], attn._attend(q, k, v).to(x.dtype), cfg.quant)


def _enc_kv(params, enc_out, cfg: ArchConfig):
    hd = cfg.resolved_head_dim
    k = attn.split_heads(cm.linear(params["wk"], enc_out, cfg.quant), cfg.n_kv_heads, hd)
    v = attn.split_heads(cm.linear(params["wv"], enc_out, cfg.quant), cfg.n_kv_heads, hd)
    return k, v


def _walk(stacked, body, x, cfg: ArchConfig):
    """``x = body(layer i, x)`` over a stack; ``cfg.remat`` recomputes each
    layer in backward."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(_n_layers(stacked)):
        layer = cm.tree_index(stacked, i)
        x = checkpoint(body, layer, x, use_reentrant=False) if remat else body(layer, x)
    return x


def encode(params, cfg: ArchConfig, frame_embeds):
    """frame_embeds: [B, Se, D] (stub frontend output) -> encoder states."""
    B, Se, D = frame_embeds.shape
    dev = frame_embeds.device
    dt = cfg.torch_dtype
    x = frame_embeds.to(dt) + cm.sinusoidal_positions(Se, D, device=dev).to(dt)[None]
    mask = torch.ones((Se, Se), dtype=torch.bool, device=dev)     # bidirectional
    positions = torch.arange(Se, device=dev)[None, :]

    def body(layer, x):
        h = cm.rms_norm(layer["ln1"], x, cfg.norm_eps)
        x = x + attn.attn_forward(layer["attn"], h, cfg, positions=positions, mask=mask)
        h = cm.rms_norm(layer["ln2"], x, cfg.norm_eps)
        return x + ffn_mod.ffn_forward(layer["ffn"], h, cfg)

    x = _walk(params["enc_layers"], body, x, cfg)
    return cm.rms_norm(params["enc_norm"], x, cfg.norm_eps)


def _logits(params, cfg: ArchConfig, x):
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return cm.softcap(cm.unembed(params["embed"], x), cfg.logit_softcap)


def encdec_forward(params, cfg: ArchConfig, tokens, frame_embeds):
    """Teacher-forced full-sequence forward -> logits [B, S, V]; each decoder
    layer recomputes its cross K/V from the encoder output."""
    enc_out = encode(params, cfg, frame_embeds)
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    mask = cm.causal_mask(S, device=x.device)

    def body(layer, x):
        h = cm.rms_norm(layer["ln1"], x, cfg.norm_eps)
        x = x + attn.attn_forward(layer["attn"], h, cfg, positions=positions, mask=mask)
        h = cm.rms_norm(layer["ln_x"], x, cfg.norm_eps)
        x = x + _cross_attend(layer["xattn"], h, _enc_kv(layer["xattn"], enc_out, cfg), cfg)
        h = cm.rms_norm(layer["ln2"], x, cfg.norm_eps)
        return x + ffn_mod.ffn_forward(layer["ffn"], h, cfg)

    return _logits(params, cfg, _walk(params["dec_layers"], body, x, cfg))


def encdec_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    n = cfg.n_layers
    self_spec = cm.tree_map(lambda s: attn.CacheSpec((n, *s.shape), s.dtype),
                            attn.attn_cache_specs(cfg, batch, max_len))
    cross = attn.CacheSpec((n, batch, cfg.encoder_len, cfg.n_kv_heads, cfg.resolved_head_dim),
                           cfg.torch_dtype)
    return {"self": self_spec, "cross_k": cross, "cross_v": cross}


def init_encdec_cache(params, cfg: ArchConfig, batch: int, max_len: int,
                      frame_embeds=None, *, device="cuda") -> dict:
    """Zeros on ``device``; with ``frame_embeds`` the encoder runs once and
    each decoder layer's cross K/V is written into its row of the cache."""
    cache = attn.init_from_specs(encdec_cache_specs(cfg, batch, max_len), device)
    if frame_embeds is not None:
        enc_out = encode(params, cfg, frame_embeds)
        for i in range(cfg.n_layers):
            k, v = _enc_kv(cm.tree_index(params["dec_layers"], i)["xattn"], enc_out, cfg)
            cache["cross_k"][i] = k
            cache["cross_v"][i] = v
    return cache


def encdec_decode_step(params, cfg: ArchConfig, tokens, pos, cache):
    """tokens [B, 1], pos [B] -> (logits [B, 1, V], cache): each layer's
    self-KV row at ``pos`` written in place, the cross K/V read from the
    cache."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    for i in range(cfg.n_layers):
        layer = cm.tree_index(params["dec_layers"], i)
        h = cm.rms_norm(layer["ln1"], x, cfg.norm_eps)
        with cm.cache_layer(cache["self"], i) as c:
            a, _ = attn.attn_decode(layer["attn"], h, cfg, c, pos)
        x = x + a
        h = cm.rms_norm(layer["ln_x"], x, cfg.norm_eps)
        x = x + _cross_attend(layer["xattn"], h, (cache["cross_k"][i], cache["cross_v"][i]), cfg)
        h = cm.rms_norm(layer["ln2"], x, cfg.norm_eps)
        x = x + ffn_mod.ffn_forward(layer["ffn"], h, cfg)
    return _logits(params, cfg, x), cache
