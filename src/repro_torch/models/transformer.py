"""Decoder-only LM stack: dense and MoE layers, MLA, the leading dense
stack and the MTP head (port of ``repro/models/transformer.py``).

Layer params are stacked ``[L, ...]`` as in the JAX package, so a JAX tree
crosses over as it is; every walk slices layer ``i`` out of the stack (a
view) and resolves the per-layer §IV-D schedule (``cm.layer_quant_cfg``).
Two homogeneous stacks are supported: the leading dense layers
(``dense_layers``, DeepSeek-V3's 3) and the main stack (dense FFN or MoE);
a stack's ``layer0`` offset makes one schedule index the leading layers
first, then the main stack.  PyTorch runs eagerly, so the JAX package's
scanned and unrolled walks are one loop here.  ``cfg.remat`` wraps each
layer's training forward in ``torch.utils.checkpoint`` (non-reentrant), as
the JAX package wraps it in ``jax.checkpoint``: the layer's activations are
recomputed in backward, a fake-quant layer's Algorithm 2 with them.  The
VLM family's image prefix (``prefix_embeds``, precomputed patch embeddings)
is concatenated before the token embeddings: positions and the causal mask
cover prefix + tokens, and the prefix rows are sliced off after the final
norm.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ArchConfig, *, kind: str = "dense",
               device="cuda") -> dict:
    """kind: 'dense' | 'moe'."""
    if kind not in ("dense", "moe"):
        raise ValueError(f"unknown layer kind {kind!r}")
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    p = {"ln1": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
         "ln2": cm.init_rmsnorm(cfg.d_model, dt, device=dev),
         "attn": (attn.init_mla if cfg.use_mla else attn.init_attn)(gen, cfg, device=dev)}
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device=dev)
    else:
        d_ff = cfg.d_ff if cfg.d_ff else (cfg.d_ff_expert or 128)
        p["ffn"] = ffn_mod.init_ffn(gen, cfg, d_ff=d_ff, device=dev)
    return p


def _ffn_block(params, x, cfg: ArchConfig):
    """x + the layer's FFN (dense or MoE) -> (x, aux)."""
    h = cm.rms_norm(params["ln2"], x, cfg.norm_eps)
    if "moe" in params:
        f, aux = moe_mod.moe_ffn(params["moe"], h, cfg)
        return x + f, aux
    return x + ffn_mod.ffn_forward(params["ffn"], h, cfg), {}


def layer_forward(params, x, cfg: ArchConfig, *, positions=None, mask=None):
    """-> (x, aux): aux holds a MoE layer's load-balance loss and dropped
    fraction, and is empty for a dense layer."""
    x = cm.shard(x, "batch", "seq", None)
    h = cm.rms_norm(params["ln1"], x, cfg.norm_eps)
    fwd = attn.mla_forward if cfg.use_mla else attn.attn_forward
    # the residual placed as at the layer's start (whole on "model", where
    # wo left it split): the FFN's norm then sums each row whole, as
    # single-process does, not as partial sums over "model"
    x = cm.shard(x + fwd(params["attn"], h, cfg, positions=positions, mask=mask),
                 "batch", "seq", None)
    return _ffn_block(params, x, cfg)


def layer_decode(params, x, cfg: ArchConfig, cache, pos):
    h = cm.rms_norm(params["ln1"], x, cfg.norm_eps)
    a, cache = (attn.mla_decode if cfg.use_mla else attn.attn_decode)(
        params["attn"], h, cfg, cache, pos)
    return _ffn_block(params, x + a, cfg)[0], cache


def layer_prefill(params, x, cfg: ArchConfig, *, positions, mask, max_len):
    """Full-sequence layer pass that also emits the layer's decode cache."""
    h = cm.rms_norm(params["ln1"], x, cfg.norm_eps)
    a, kv = (attn.mla_prefill if cfg.use_mla else attn.attn_prefill)(
        params["attn"], h, cfg, max_len=max_len, positions=positions, mask=mask)
    return _ffn_block(params, x + a, cfg)[0], kv


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def _init_stack(gen: torch.Generator, cfg: ArchConfig, n: int, kind: str, dev) -> dict:
    return cm.stack_trees([init_layer(gen, cfg, kind=kind, device=dev) for _ in range(n)])


def init_lm(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    main_kind = "moe" if cfg.n_experts else "dense"
    p = {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev),
         "layers": _init_stack(gen, cfg, cfg.n_layers - cfg.n_dense_layers, main_kind, dev),
         "final_norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev)}
    if cfg.n_dense_layers:
        p["dense_layers"] = _init_stack(gen, cfg, cfg.n_dense_layers, "dense", dev)
    if not cfg.tie_embeddings:
        p["unembed"] = cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev)
    if cfg.mtp_depth:
        p["mtp"] = {"proj": cm.init_linear(gen, 2 * cfg.d_model, cfg.d_model, dt, device=dev),
                    "layer": init_layer(gen, cfg, kind="dense", device=dev),
                    "norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev)}
    return p


def _n_layers(stacked) -> int:
    return stacked["ln1"]["scale"].shape[0]


def _stacks(params, cfg: ArchConfig):
    """(key, global index of its first layer) of each stack present, in
    order: the leading dense layers, then the main stack."""
    out = [("dense_layers", 0)] if "dense_layers" in params else []
    return out + [("layers", cfg.n_dense_layers)]


def _run_stack(stacked, x, cfg: ArchConfig, positions, mask, *, layer0: int = 0):
    """Walk a homogeneous stack -> (x, summed load-balance loss).  ``layer0``
    is the stack's global layer offset, so a per-layer schedule indexes the
    leading dense layers first, then the main stack."""
    remat = cfg.remat and torch.is_grad_enabled()
    total = torch.zeros((), device=x.device)
    for i in range(_n_layers(stacked)):
        args = (cm.tree_index(stacked, i), x, cm.layer_quant_cfg(cfg, layer0 + i))
        if remat:
            x, aux = checkpoint(layer_forward, *args, positions=positions, mask=mask,
                                use_reentrant=False)
        else:
            x, aux = layer_forward(*args, positions=positions, mask=mask)
        if "load_balance_loss" in aux:
            total = total + aux["load_balance_loss"]
    return x, total


def _embed(params, cfg: ArchConfig, tokens, prefix_embeds=None):
    """Embeddings (after an optional prefix), their positions and mask."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    return x, positions, cm.causal_mask(S, cfg.sliding_window, device=x.device)


def lm_hidden(params, cfg: ArchConfig, tokens, *, prefix_embeds=None):
    """Token (after an optional prefix's) embeddings -> final hidden states
    of the tokens, and the aux dict with the load-balance loss summed over
    the MoE layers (0 for a dense stack)."""
    x, positions, mask = _embed(params, cfg, tokens, prefix_embeds)
    lb_total = torch.zeros((), device=x.device)
    for key, layer0 in _stacks(params, cfg):
        x, lb = _run_stack(params[key], x, cfg, positions, mask, layer0=layer0)
        lb_total = lb_total + lb
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    return x, {"load_balance_loss": lb_total}


def lm_logits(params, cfg: ArchConfig, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = cm.shard(cm.unembed(table, hidden), "batch", None, "vocab")
    return cm.softcap(logits, cfg.logit_softcap)


def lm_forward(params, cfg: ArchConfig, tokens, *, prefix_embeds=None):
    hidden, aux = lm_hidden(params, cfg, tokens, prefix_embeds=prefix_embeds)
    return lm_logits(params, cfg, hidden), aux


def mtp_logits(params, cfg: ArchConfig, hidden, tokens):
    """DeepSeek-V3 multi-token prediction: predict t+2 from (h_t, emb_{t+1}).

    hidden: [B, S, D] main-stack output; tokens: [B, S].  Returns logits for
    positions predicting tokens[t+2] (length S-1, caller aligns labels).
    """
    emb_next = cm.embed(params["embed"], tokens[:, 1:]).to(hidden.dtype)
    h = torch.cat([hidden[:, :-1], emb_next], dim=-1)
    h = cm.linear(params["mtp"]["proj"], h, cfg.quant)
    S = h.shape[1]
    h, _ = layer_forward(params["mtp"]["layer"], h, cfg,
                         positions=torch.arange(S, device=h.device)[None, :],
                         mask=cm.causal_mask(S, device=h.device))
    h = cm.rms_norm(params["mtp"]["norm"], h, cfg.norm_eps)
    return lm_logits(params, cfg, h)


# --- decode -----------------------------------------------------------------

def lm_cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    one = (attn.mla_cache_specs if cfg.use_mla else attn.attn_cache_specs)(
        cfg, batch, max_len)

    def stack(n):
        return cm.tree_map(lambda s: attn.CacheSpec((n, *s.shape), s.dtype), one)

    spec = {"layers": stack(cfg.n_layers - cfg.n_dense_layers)}
    if cfg.n_dense_layers:
        spec["dense_layers"] = stack(cfg.n_dense_layers)
    return spec


def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    return attn.init_from_specs(lm_cache_specs(cfg, batch, max_len), device)


def _decode_stack(stacked, caches, x, cfg: ArchConfig, pos, *, layer0: int = 0):
    """Each layer's cache slice is written in place by the attention's
    decode (``cm.cache_layer``: a view of the stacked cache, or written
    back where it cannot be one)."""
    for i in range(_n_layers(stacked)):
        with cm.cache_layer(caches, i) as c:
            x, _ = layer_decode(cm.tree_index(stacked, i), x, cm.layer_quant_cfg(cfg, layer0 + i),
                                c, pos)
    return x, caches


def _prefill_stack(stacked, x, cfg: ArchConfig, positions, mask, max_len, *,
                   layer0: int = 0):
    """Run the stack over the full sequence, collecting each layer's decode
    cache (stacked [L, ...], same layout as lm_cache_specs)."""
    caches = []
    for i in range(_n_layers(stacked)):
        x, kv = layer_prefill(cm.tree_index(stacked, i), x,
                              cm.layer_quant_cfg(cfg, layer0 + i),
                              positions=positions, mask=mask, max_len=max_len)
        caches.append(kv)
    return x, cm.stack_trees(caches)


def lm_prefill(params, cfg: ArchConfig, tokens, *, max_len: int):
    """Bulk prefill: one full-sequence pass -> (logits [B, S, V], cache) with
    positions 0..S-1 populated, the same state as S ``lm_decode_step``
    calls."""
    x, positions, mask = _embed(params, cfg, tokens)
    cache = {}
    for key, layer0 in _stacks(params, cfg):
        x, cache[key] = _prefill_stack(params[key], x, cfg, positions, mask, max_len,
                                       layer0=layer0)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), cache


def lm_decode_step(params, cfg: ArchConfig, tokens, pos, cache):
    """tokens: [B, 1], pos: [B] -> (logits [B, 1, V], cache updated in place)."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    for key, layer0 in _stacks(params, cfg):
        x, _ = _decode_stack(params[key], cache[key], x, cfg, pos, layer0=layer0)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), cache
