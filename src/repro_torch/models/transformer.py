"""Decoder-only LM stack, dense family (port of ``repro/models/transformer.py``).

Layer params are stacked ``[L, ...]`` as in the JAX package, so a JAX tree
crosses over as it is; every walk slices layer ``i`` out of the stack (a
view) and resolves the per-layer §IV-D schedule (``cm.layer_quant_cfg``).
PyTorch runs eagerly, so the JAX package's scanned and unrolled walks are
one loop here.  ``cfg.remat`` wraps each layer's training forward in
``torch.utils.checkpoint`` (non-reentrant), as the JAX package wraps it in
``jax.checkpoint``: the layer's activations are recomputed in backward, a
fake-quant layer's Algorithm 2 with them.  MoE / MLA layers, the leading dense stack and the MTP head
wait with MoE (ROADMAP item 12b).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} waits for ROADMAP items 12b-12e")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ArchConfig, *, kind: str = "dense",
               device="cuda") -> dict:
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} waits for ROADMAP item 12b")
    _require_dense(cfg)
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    return {
        "ln1": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
        "ln2": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
        "attn": attn.init_attn(gen, cfg, device=dev),
        "ffn": ffn_mod.init_ffn(gen, cfg, d_ff=cfg.d_ff, device=dev),
    }


def _ffn_block(params, x, cfg: ArchConfig):
    h = cm.rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + ffn_mod.ffn_forward(params["ffn"], h, cfg)


def layer_forward(params, x, cfg: ArchConfig, *, positions=None, mask=None):
    h = cm.rms_norm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_forward(params["attn"], h, cfg, positions=positions, mask=mask)
    return _ffn_block(params, x, cfg)


def layer_decode(params, x, cfg: ArchConfig, cache, pos):
    h = cm.rms_norm(params["ln1"], x, cfg.norm_eps)
    a, cache = attn.attn_decode(params["attn"], h, cfg, cache, pos)
    return _ffn_block(params, x + a, cfg), cache


def layer_prefill(params, x, cfg: ArchConfig, *, positions, mask, max_len):
    """Full-sequence layer pass that also emits the layer's decode cache."""
    h = cm.rms_norm(params["ln1"], x, cfg.norm_eps)
    a, kv = attn.attn_prefill(params["attn"], h, cfg, max_len=max_len,
                              positions=positions, mask=mask)
    return _ffn_block(params, x + a, cfg), kv


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    _require_dense(cfg)
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    p = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)}
    p["layers"] = cm.stack_trees([init_layer(gen, cfg, device=dev)
                                  for _ in range(cfg.n_layers)])
    p["final_norm"] = cm.init_rmsnorm(cfg.d_model, dt, device=dev)
    if not cfg.tie_embeddings:
        p["unembed"] = cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)
    return p


def _n_layers(stacked) -> int:
    return stacked["ln1"]["scale"].shape[0]


def _run_stack(stacked, x, cfg: ArchConfig, positions, mask):
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(_n_layers(stacked)):
        args = (cm.tree_index(stacked, i), x, cm.layer_quant_cfg(cfg, i))
        if remat:
            x = checkpoint(layer_forward, *args, positions=positions, mask=mask,
                           use_reentrant=False)
        else:
            x = layer_forward(*args, positions=positions, mask=mask)
    return x


def _embed(params, cfg: ArchConfig, tokens):
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    return x, positions, cm.causal_mask(S, cfg.sliding_window, device=x.device)


def lm_hidden(params, cfg: ArchConfig, tokens):
    """Token embeddings -> final hidden states, and the aux dict (a dense
    stack has no load-balance loss)."""
    x, positions, mask = _embed(params, cfg, tokens)
    x = _run_stack(params["layers"], x, cfg, positions, mask)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, {"load_balance_loss": torch.zeros((), device=x.device)}


def lm_logits(params, cfg: ArchConfig, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return cm.softcap(cm.unembed(table, hidden), cfg.logit_softcap)


def lm_forward(params, cfg: ArchConfig, tokens):
    hidden, aux = lm_hidden(params, cfg, tokens)
    return lm_logits(params, cfg, hidden), aux


# --- decode -----------------------------------------------------------------

def lm_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    one = attn.attn_cache_specs(cfg, batch, max_len)
    return {"layers": cm.tree_map(
        lambda s: attn.CacheSpec((cfg.n_layers, *s.shape), s.dtype), one)}


def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    return attn.init_from_specs(lm_cache_specs(cfg, batch, max_len), device)


def _decode_stack(stacked, caches, x, cfg: ArchConfig, pos):
    """Each layer's cache slice is a view of the stacked cache, written in
    place by ``attn_decode``."""
    for i in range(_n_layers(stacked)):
        x, _ = layer_decode(cm.tree_index(stacked, i), x, cm.layer_quant_cfg(cfg, i),
                            cm.tree_index(caches, i), pos)
    return x, caches


def _prefill_stack(stacked, x, cfg: ArchConfig, positions, mask, max_len):
    """Run the stack over the full sequence, collecting each layer's decode
    cache (stacked [L, ...], same layout as lm_cache_specs)."""
    caches = []
    for i in range(_n_layers(stacked)):
        x, kv = layer_prefill(cm.tree_index(stacked, i), x, cm.layer_quant_cfg(cfg, i),
                              positions=positions, mask=mask, max_len=max_len)
        caches.append(kv)
    return x, cm.stack_trees(caches)


def lm_prefill(params, cfg: ArchConfig, tokens, *, max_len: int):
    """Bulk prefill: one full-sequence pass -> (logits [B, S, V], cache) with
    positions 0..S-1 populated, the same state as S ``lm_decode_step``
    calls."""
    x, positions, mask = _embed(params, cfg, tokens)
    x, nc = _prefill_stack(params["layers"], x, cfg, positions, mask, max_len)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), {"layers": nc}


def lm_decode_step(params, cfg: ArchConfig, tokens, pos, cache):
    """tokens: [B, 1], pos: [B] -> (logits [B, 1, V], cache updated in place)."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    x, _ = _decode_stack(params["layers"], cache["layers"], x, cfg, pos)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), cache
