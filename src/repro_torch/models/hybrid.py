"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block,
arXiv:2411.15242 (port of ``repro/models/hybrid.py``).

The backbone is a stack of Mamba2 blocks; after every ``hybrid_attn_every``
of them, one shared attention + MLP block (one set of parameters, reused at
every application point) processes concat(current hidden, original
embedding) projected back to d_model.  Each application point keeps its own
KV cache.  The shared block at a point takes the per-layer §IV-D config of
the Mamba2 layer it follows, so a schedule entry governs both.  PyTorch runs
eagerly, so the JAX package's scanned and unrolled walks are one loop here.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod


def n_attn_points(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


def _is_point(cfg: ArchConfig, i: int) -> bool:
    """Whether the shared block runs after Mamba2 layer ``i``."""
    return (i + 1) % cfg.hybrid_attn_every == 0


def init_shared(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    return {"in_proj": cm.init_linear(gen, 2 * cfg.d_model, cfg.d_model, dt, device=dev),
            "ln1": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "ln2": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
            "attn": attn.init_attn(gen, cfg, device=dev),
            "ffn": ffn_mod.init_ffn(gen, cfg, device=dev)}


def init_hybrid(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    return {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev),
            "mamba_layers": ssm_mod.init_mamba_layers(gen, cfg, device=dev),
            "shared": init_shared(gen, cfg, device=dev),
            "final_norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev)}


def _shared_block(shared, x, x0, cfg: ArchConfig, *, positions, mask):
    h = cm.linear(shared["in_proj"], torch.cat([x, x0], dim=-1), cfg.quant)
    h = h + attn.attn_forward(shared["attn"], cm.rms_norm(shared["ln1"], h, cfg.norm_eps),
                              cfg, positions=positions, mask=mask)
    f = ffn_mod.ffn_forward(shared["ffn"], cm.rms_norm(shared["ln2"], h, cfg.norm_eps), cfg)
    return x + h + f


def _layer(layer, shared, x, x0, cfg_i: ArchConfig, point: bool, positions, mask):
    """Mamba2 layer i, then the shared block where layer i ends a period."""
    h = cm.rms_norm(layer["norm"], x, cfg_i.norm_eps)
    # the block's sequence-split output gathered: the shared attention
    # block and its FFN take the residual on the batch's rows
    x = x + cm.shard(ssm_mod.mamba2_forward(layer["block"], h, cfg_i), "batch", "seq", None)
    if point:
        x = _shared_block(shared, x, x0, cfg_i, positions=positions, mask=mask)
    return x


def hybrid_hidden(params, cfg: ArchConfig, tokens):
    """Token embeddings -> final hidden states.  ``cfg.remat`` recomputes
    each layer (with its shared block) in backward."""
    x, positions, mask = tf_mod._embed(params, cfg, tokens)
    x0 = x
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        args = (cm.tree_index(params["mamba_layers"], i), params["shared"], x, x0,
                cm.layer_quant_cfg(cfg, i), _is_point(cfg, i), positions, mask)
        x = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
    # the final norm and the head on each model rank's tokens (``cm.unembed``)
    return cm.rms_norm(params["final_norm"], ssm_mod.split_sequence(x), cfg.norm_eps)


def hybrid_forward(params, cfg: ArchConfig, tokens):
    """Logits [B, S, V] in fp32; the embedding table unembeds (the JAX
    package's rule for this family)."""
    return cm.unembed(params["embed"], hybrid_hidden(params, cfg, tokens))


# --- decode -----------------------------------------------------------------

def hybrid_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    def stack(n, one):
        return cm.tree_map(lambda s: attn.CacheSpec((n, *s.shape), s.dtype), one)

    return {"mamba": stack(cfg.n_layers, ssm_mod.mamba2_cache_specs(cfg, batch)),
            "attn": stack(n_attn_points(cfg), attn.attn_cache_specs(cfg, batch, max_len))}


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    return attn.init_from_specs(hybrid_cache_specs(cfg, batch, max_len), device)


def _shared_block_decode(shared, x, x0, cfg: ArchConfig, cache, pos):
    """The shared block at one point for one token; ``cache`` is that
    point's KV cache (a view of the stacked one), written in place."""
    h = cm.linear(shared["in_proj"], torch.cat([x, x0], dim=-1), cfg.quant)
    a, cache = attn.attn_decode(shared["attn"], cm.rms_norm(shared["ln1"], h, cfg.norm_eps),
                                cfg, cache, pos)
    h = h + a
    f = ffn_mod.ffn_forward(shared["ffn"], cm.rms_norm(shared["ln2"], h, cfg.norm_eps), cfg)
    return x + h + f, cache


def hybrid_decode_step(params, cfg: ArchConfig, tokens, pos, cache, update_mask=None):
    """One-token decode -> (logits [B, 1, V], cache written in place).

    ``update_mask`` ([B] bool, optional) gates the recurrent state write-back
    per row (``ssm.mamba2_decode``); the positional attention caches need no
    mask: a non-updated row's k/v lands at a position its owner has not
    attended past and is overwritten by the owner's next real decode."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    x0 = x
    shared = params["shared"]
    for i in range(cfg.n_layers):
        cfg_i = cm.layer_quant_cfg(cfg, i)
        layer = cm.tree_index(params["mamba_layers"], i)
        h = cm.rms_norm(layer["norm"], x, cfg_i.norm_eps)
        with cm.cache_layer(cache["mamba"], i) as c:
            d, _ = ssm_mod.mamba2_decode(layer["block"], h, cfg_i, c, update_mask=update_mask)
        x = x + d
        if _is_point(cfg, i):
            with cm.cache_layer(cache["attn"], i // cfg.hybrid_attn_every) as c:
                x, _ = _shared_block_decode(shared, x, x0, cfg_i, c, pos)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return cm.unembed(params["embed"], x), cache


def _shared_block_prefill(shared, x, x0, cfg: ArchConfig, *, positions, mask, max_len):
    h = cm.linear(shared["in_proj"], torch.cat([x, x0], dim=-1), cfg.quant)
    a, kv = attn.attn_prefill(shared["attn"], cm.rms_norm(shared["ln1"], h, cfg.norm_eps), cfg,
                              max_len=max_len, positions=positions, mask=mask)
    h = h + a
    f = ffn_mod.ffn_forward(shared["ffn"], cm.rms_norm(shared["ln2"], h, cfg.norm_eps), cfg)
    return x + h + f, kv


def hybrid_prefill(params, cfg: ArchConfig, tokens, *, max_len: int):
    """Bulk prefill: one full-sequence pass -> (logits [B, S, V], cache) with
    the SSM state after token S-1 and each point's KV rows 0..S-1, the same
    state as S ``hybrid_decode_step`` calls."""
    x, positions, mask = tf_mod._embed(params, cfg, tokens)
    x0 = x
    shared = params["shared"]
    mamba_caches, attn_caches = [], []
    for i in range(cfg.n_layers):
        cfg_i = cm.layer_quant_cfg(cfg, i)
        layer = cm.tree_index(params["mamba_layers"], i)
        h = cm.rms_norm(layer["norm"], x, cfg_i.norm_eps)
        d, mc = ssm_mod.mamba2_prefill(layer["block"], h, cfg_i)
        x = x + d
        mamba_caches.append(mc)
        if _is_point(cfg, i):
            x, kv = _shared_block_prefill(shared, x, x0, cfg_i, positions=positions, mask=mask,
                                          max_len=max_len)
            attn_caches.append(kv)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return cm.unembed(params["embed"], x), {"mamba": cm.stack_trees(mamba_caches),
                                            "attn": cm.stack_trees(attn_caches)}
