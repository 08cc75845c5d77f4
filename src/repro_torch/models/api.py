"""Unified model API for every LM family (port of ``repro/models/api.py``).

The surface the serving runtime, tests and ``chip_smoke.py`` use:

  init_params(cfg, gen)                  -> params tree (stacked layers)
  forward(cfg, params, batch)            -> (logits, aux)
  loss_fn(cfg, params, batch)            -> (loss, metrics)
  cache_specs / init_cache               -> decode cache
  decode_step(cfg, params, batch)        -> (logits, cache)
  prefill(cfg, params, tokens, max_len)  -> (logits, cache)
  scatter_cache(cfg, cache, slot, part)  -> cache
  binarize_model_params(cfg, params)     -> packed deployment tree
  param_shapes(cfg, qc=None)             -> the fp (or packed) tree as meta tensors
  count_params(cfg, active_only=False)   -> int

The families: dense and MoE (MLA, leading dense layers, MTP), SSM (a
Mamba2 stack), hybrid (Zamba2), enc-dec (Whisper: ``batch["frame_embeds"]``)
and VLM (InternVL2: the LM stack after ``batch["patch_embeds"]``); another
family name raises ``ValueError``.  The SSM and hybrid families unembed
with the embedding table whatever ``tie_embeddings`` says, as in the JAX
package.  The enc-dec and VLM families have no bulk prefill, as in the JAX
package: ``prefill`` and ``scatter_cache`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import binlinear as bl
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def init_params(cfg: ArchConfig, gen: torch.Generator, *, device="cuda") -> dict:
    """fp params drawn from ``gen`` (on the generator's device), placed on
    ``device``."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return tf_mod.init_lm(gen, cfg, device=dev)
    if cfg.family == "ssm":
        return _init_ssm_lm(gen, cfg, dev)
    if cfg.family == "hybrid":
        return hybrid_mod.init_hybrid(gen, cfg, device=dev)
    if cfg.family == "encdec":
        return encdec_mod.init_encdec(gen, cfg, device=dev)
    raise ValueError(cfg.family)


def _init_ssm_lm(gen: torch.Generator, cfg: ArchConfig, dev) -> dict:
    dt = cfg.torch_dtype
    return {"embed": cm.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device=dev),
            "mamba_layers": ssm_mod.init_mamba_layers(gen, cfg, device=dev),
            "final_norm": cm.init_rmsnorm(cfg.d_model, dt, device=dev)}


def _ssm_layer(layer, x, cfg_i: ArchConfig):
    h = cm.rms_norm(layer["norm"], x, cfg_i.norm_eps)
    return x + ssm_mod.mamba2_forward(layer["block"], h, cfg_i)


def _ssm_hidden(params, cfg: ArchConfig, tokens):
    """The Mamba2 stack's final hidden states; ``cfg.remat`` recomputes each
    layer in backward, as ``transformer._run_stack`` does."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        args = (cm.tree_index(params["mamba_layers"], i), x, cm.layer_quant_cfg(cfg, i))
        x = checkpoint(_ssm_layer, *args, use_reentrant=False) if remat else _ssm_layer(*args)
    return cm.rms_norm(params["final_norm"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward -> (logits [B, S, V], aux dict)."""
    tokens = batch["tokens"]
    if cfg.family in ("dense", "moe"):
        return tf_mod.lm_forward(params, cfg, tokens)
    if cfg.family == "vlm":
        return tf_mod.lm_forward(params, cfg, tokens, prefix_embeds=batch["patch_embeds"])
    if cfg.family == "ssm":
        return cm.unembed(params["embed"], _ssm_hidden(params, cfg, tokens)), {}
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_forward(params, cfg, tokens), {}
    if cfg.family == "encdec":
        return encdec_mod.encdec_forward(params, cfg, tokens, batch["frame_embeds"]), {}
    raise ValueError(cfg.family)


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token cross-entropy over fp32 logits (+ MoE load balance x 0.01
    + MTP x 0.3) -> (loss, metrics).  With ``cfg.onehot_loss`` the CE is
    logsumexp minus a one-hot contraction (the JAX package's vocab-sharded
    form), else log-softmax and a gather.  The VLM family's hidden states
    (and its MTP head's input) are those of the tokens after the prefix."""
    tokens, labels = batch["tokens"], batch["labels"].long()
    if cfg.family in ("dense", "moe", "vlm"):
        prefix = batch["patch_embeds"] if cfg.family == "vlm" else None
        hidden, aux = tf_mod.lm_hidden(params, cfg, tokens, prefix_embeds=prefix)
        logits = tf_mod.lm_logits(params, cfg, hidden)
    else:
        logits, aux = forward(cfg, params, batch)
    if cfg.onehot_loss:
        lg = logits.to(torch.float32)
        onehot = F.one_hot(labels, lg.shape[-1]).to(lg.dtype)
        nll = torch.logsumexp(lg, dim=-1) - torch.einsum("bsv,bsv->bs", lg, onehot)
    else:
        nll = _nll(logits, labels)
    loss = torch.mean(nll)
    metrics = {"ce_loss": loss}
    if cfg.n_experts:
        lb = aux["load_balance_loss"] * 0.01
        loss = loss + lb
        metrics["load_balance_loss"] = lb
    if cfg.mtp_depth:
        # MTP: logits at position t predict labels[t+1] (== tokens[t+2])
        mtp_loss = 0.3 * torch.mean(_nll(tf_mod.mtp_logits(params, cfg, hidden, tokens),
                                         labels[:, 1:]))
        loss = loss + mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The VLM cache holds ``n_image_tokens`` more rows than ``max_len``."""
    if cfg.family in ("dense", "moe"):
        return tf_mod.lm_cache_specs(cfg, batch, max_len)
    if cfg.family == "vlm":
        return tf_mod.lm_cache_specs(cfg, batch, max_len + cfg.n_image_tokens)
    if cfg.family == "ssm":
        return cm.tree_map(lambda s: attn.CacheSpec((cfg.n_layers, *s.shape), s.dtype),
                           ssm_mod.mamba2_cache_specs(cfg, batch))
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_cache_specs(cfg, batch, max_len)
    if cfg.family == "encdec":
        return encdec_mod.encdec_cache_specs(cfg, batch, max_len)
    raise ValueError(cfg.family)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Zeros (-1 for a sliding window's int32 ``slot_pos``) on ``device``;
    an enc-dec cache's cross K/V stays zero (``encdec.init_encdec_cache``
    fills it from frame embeddings)."""
    return attn.init_from_specs(cache_specs(cfg, batch, max_len), device)


def decode_step(cfg: ArchConfig, params, batch):
    """batch: tokens [B,1], pos [B], cache -> (logits [B,1,V], cache), the
    cache written in place.  An optional ``batch["update_mask"]`` ([B] bool)
    gates the *recurrent* state write-back per row for ssm/hybrid (rows
    outside a serving group keep their state bit for bit; their logits are
    garbage and ignored).  Positional KV caches need no mask (see
    ``launch/serve.py``'s transient-row invariant), so the other families
    ignore it."""
    tokens, pos, cache = batch["tokens"], batch["pos"], batch["cache"]
    if cfg.family in ("dense", "moe", "vlm"):
        return tf_mod.lm_decode_step(params, cfg, tokens, pos, cache)
    if cfg.family == "ssm":
        return _ssm_decode(params, cfg, tokens, cache, update_mask=batch.get("update_mask"))
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_decode_step(params, cfg, tokens, pos, cache,
                                             update_mask=batch.get("update_mask"))
    if cfg.family == "encdec":
        return encdec_mod.encdec_decode_step(params, cfg, tokens, pos, cache)
    raise ValueError(cfg.family)


def _ssm_decode(params, cfg: ArchConfig, tokens, cache, update_mask=None):
    """Each layer's cache slice is written in place by ``mamba2_decode``
    (``cm.cache_layer``: a view of the stacked cache, or written back
    where it cannot be one)."""
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    for i in range(cfg.n_layers):
        cfg_i = cm.layer_quant_cfg(cfg, i)
        layer = cm.tree_index(params["mamba_layers"], i)
        h = cm.rms_norm(layer["norm"], x, cfg_i.norm_eps)
        with cm.cache_layer(cache, i) as c:
            d, _ = ssm_mod.mamba2_decode(layer["block"], h, cfg_i, c, update_mask=update_mask)
        x = x + d
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return cm.unembed(params["embed"], x), cache


# families with a bulk prefill in the JAX package; the serving runtime
# falls back to token-wise warmup for the others (encdec, vlm)
BULK_PREFILL_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _bulk_only(cfg: ArchConfig) -> None:
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(f"bulk prefill not implemented for family={cfg.family!r}")
    if cfg.family not in BULK_PREFILL_FAMILIES:
        raise ValueError(cfg.family)


def prefill(cfg: ArchConfig, params, tokens, *, max_len: int):
    """Bulk prefill: tokens [B, S] -> (logits [B, S, V], decode cache shaped
    like ``cache_specs(cfg, B, max_len)`` with positions 0..S-1 populated),
    the same state as S ``decode_step`` calls in one forward."""
    _bulk_only(cfg)
    if cfg.family == "ssm":
        return _ssm_prefill(params, cfg, tokens)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_prefill(params, cfg, tokens, max_len=max_len)
    return tf_mod.lm_prefill(params, cfg, tokens, max_len=max_len)


def _ssm_prefill(params, cfg: ArchConfig, tokens):
    x = cm.embed(params["embed"], tokens).to(cfg.torch_dtype)
    caches = []
    for i in range(cfg.n_layers):
        cfg_i = cm.layer_quant_cfg(cfg, i)
        layer = cm.tree_index(params["mamba_layers"], i)
        h = cm.rms_norm(layer["norm"], x, cfg_i.norm_eps)
        d, c = ssm_mod.mamba2_prefill(layer["block"], h, cfg_i)
        x = x + d
        caches.append(c)
    x = cm.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return cm.unembed(params["embed"], x), cm.stack_trees(caches)


def scatter_cache(cfg: ArchConfig, cache, slot: int, part):
    """Write a B=1 prefill cache into batch row ``slot`` of a serving cache,
    in place (leaves are [L, B, ...]); other rows are untouched."""
    _bulk_only(cfg)

    def put(full, p):
        full[:, slot] = p[:, 0]
        return full

    return cm.tree_map(put, cache, part)


# ---------------------------------------------------------------------------
# deployment binarization (the paper's technique, model-wide)
# ---------------------------------------------------------------------------

# routers/embeddings/SSM dynamics stay fp; MLA wuk/wuv stay fp (the JAX
# package's list, kept whole so the two agree on every tree)
BINARIZE_EXCLUDE = ("router", "embed", "unembed", "conv_", "A_log",
                    "dt_bias", "norm", "wuk", "wuv")


def _map_linears(params, one):
    """``one({'w', 'b'?})`` on every eligible linear: dict leaves holding a
    2D 'w' under a path not excluded in BINARIZE_EXCLUDE; a stacked-layer
    weight ([L, K, N]) layer by layer, the results stacked."""
    def convert(path, subtree):
        if not isinstance(subtree, dict):
            return subtree
        pstr = "/".join(path)
        w = subtree.get("w")
        if isinstance(w, torch.Tensor) and not any(e in pstr for e in BINARIZE_EXCLUDE):
            if w.ndim == 2:
                return one(subtree)
            if w.ndim == 3:
                stacked = cm.stack_trees([one({"w": wi}) for wi in w])
                if "b" in subtree:
                    stacked["b"] = subtree["b"]
                return stacked
        return {k: convert(path + (k,), v) for k, v in subtree.items()}

    return convert((), params)


def binarize_model_params(cfg: ArchConfig, params, *, qc=None):
    """Convert every eligible linear's fp weights to packed-binary form
    (stacked weights layer by layer, as the JAX package's vmap does)."""
    qc = qc or cfg.quant
    return _map_linears(params, lambda sub: bl.binarize_params(sub, qc))


def param_shapes(cfg: ArchConfig, *, qc=None):
    """The params tree of ``init_params(cfg)`` as ``meta`` tensors (shape
    and dtype, no storage): the port's ``jax.eval_shape(init_params)``.
    With a binary ``qc``, the tree ``binarize_model_params(cfg, params,
    qc=qc)`` gives, from ``binlinear.packed_shapes`` (Algorithm 2's early
    exit reads data, so it cannot run on shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator(), device="cpu")
    shapes = cm.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)
    if qc is not None and qc.mode == "binary":
        shapes = _map_linears(shapes, lambda sub: bl.packed_shapes(sub, qc))
    return shapes


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    if cfg.use_mla:
        H, qk, r, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        ql, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        q = d * ql + ql + ql * H * (qk + r) if ql else d * H * (qk + r)
        return q + d * (kvr + r) + kvr + kvr * H * qk + kvr * H * vd + H * vd * d
    hd = cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    n = d * q + 2 * d * kv + q * d
    if cfg.qkv_bias:
        n += q + 2 * kv
    if cfg.qk_norm:
        n += 2 * hd
    return n


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    return (3 if cfg.activation in ("swiglu", "geglu") else 2) * cfg.d_model * d_ff


def _mamba_layer_params(cfg: ArchConfig) -> int:
    """One {norm, block} entry of ``mamba_layers``."""
    d_inner, H, conv_ch = ssm_mod._dims(cfg)
    proj_out = 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + H
    return (cfg.d_model * proj_out + d_inner * cfg.d_model          # in_proj, out_proj
            + (cfg.ssm_conv_width + 1) * conv_ch + 3 * H + d_inner  # conv, A_log/D/dt_bias, norm
            + cfg.d_model)                                          # the layer's norm


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameter count of ``init_params(cfg)``, from the config alone;
    ``active_only`` leaves out the routed experts a token does not visit
    (the JAX package's rule: all but ``top_k`` of them in each MoE layer).
    The SSM, hybrid and enc-dec families hold one table, tied or not."""
    d = cfg.d_model
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if cfg.family == "encdec":   # encoder layers: 2 norms; decoder: 3 norms and xattn
        layer = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        return (cfg.n_encoder_layers * (layer + 2 * d)
                + cfg.n_layers * (layer + _attn_params(cfg) + 3 * d) + cfg.vocab * d + 2 * d)
    if cfg.family in ("ssm", "hybrid"):
        total = cfg.n_layers * _mamba_layer_params(cfg) + cfg.vocab * d + d
        if cfg.family == "hybrid":       # the shared block: in_proj, ln1, ln2, attn, ffn
            total += 2 * d * d + 2 * d + _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        return total
    Fe = cfg.d_ff_expert or cfg.d_ff
    attn = _attn_params(cfg) + 2 * d                       # + the two layer norms
    dense = attn + _ffn_params(cfg, cfg.d_ff or (cfg.d_ff_expert or 128))
    n_main = cfg.n_layers - cfg.n_dense_layers
    main = dense
    if cfg.n_experts:
        main = attn + d * cfg.n_experts + 3 * cfg.n_experts * d * Fe
        if cfg.n_shared_experts:
            main += _ffn_params(cfg, Fe * cfg.n_shared_experts)
    total = n_main * main + cfg.n_dense_layers * dense
    total += (1 if cfg.tie_embeddings else 2) * cfg.vocab * d + d
    if cfg.mtp_depth:
        total += 2 * d * d + dense + d
    if active_only and cfg.n_experts:
        total -= n_main * (cfg.n_experts - cfg.top_k) * 3 * d * Fe
    return total
