"""Unified model API, dense family (port of ``repro/models/api.py``).

The surface the serving runtime, tests and ``chip_smoke.py`` use:

  init_params(cfg, gen)                  -> params tree (stacked layers)
  forward(cfg, params, batch)            -> (logits, aux)
  loss_fn(cfg, params, batch)            -> (loss, metrics)
  cache_specs / init_cache               -> decode cache
  decode_step(cfg, params, batch)        -> (logits, cache)
  prefill(cfg, params, tokens, max_len)  -> (logits, cache)
  scatter_cache(cfg, cache, slot, part)  -> cache
  binarize_model_params(cfg, params)     -> packed deployment tree
  count_params(cfg)                      -> int

Only the dense family is ported; every other family raises
``NotImplementedError`` naming its ROADMAP item (the MoE load-balance and
MTP loss terms come with MoE).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import binlinear as bl
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf_mod

_WAITING = {  # family -> the ROADMAP item that ports it
    "moe": "12b (moe.py with MLA)",
    "ssm": "12c (ssm.py)",
    "hybrid": "12d (hybrid.py)",
    "encdec": "12e (encdec.py and the VLM prefix)",
    "vlm": "12e (encdec.py and the VLM prefix)",
}


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        item = _WAITING.get(cfg.family)
        if item is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(
            f"family {cfg.family!r} is not in the port yet: ROADMAP item {item}")


def init_params(cfg: ArchConfig, gen: torch.Generator, *, device="cuda") -> dict:
    """fp params drawn from ``gen`` (on the generator's device), placed on
    ``device``."""
    _dense_only(cfg)
    return tf_mod.init_lm(gen, cfg, device=resolve_device(device))


def forward(cfg: ArchConfig, params, batch):
    """Full-sequence forward -> (logits [B, S, V], aux dict)."""
    _dense_only(cfg)
    return tf_mod.lm_forward(params, cfg, batch["tokens"])


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token cross-entropy over fp32 logits -> (loss, metrics).  With
    ``cfg.onehot_loss`` it is logsumexp minus a one-hot contraction (the JAX
    package's vocab-sharded form), else log-softmax and a gather."""
    _dense_only(cfg)
    labels = batch["labels"].long()
    logits, _ = forward(cfg, params, batch)
    lg = logits.to(torch.float32)
    if cfg.onehot_loss:
        onehot = F.one_hot(labels, lg.shape[-1]).to(lg.dtype)
        nll = torch.logsumexp(lg, dim=-1) - torch.einsum("bsv,bsv->bs", lg, onehot)
    else:
        logp = torch.log_softmax(lg, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = torch.mean(nll)
    return loss, {"ce_loss": loss, "loss": loss}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    _dense_only(cfg)
    return tf_mod.lm_cache_specs(cfg, batch, max_len)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    _dense_only(cfg)
    return tf_mod.init_lm_cache(cfg, batch, max_len, device=resolve_device(device))


def decode_step(cfg: ArchConfig, params, batch):
    """batch: tokens [B,1], pos [B], cache -> (logits [B,1,V], cache), the
    cache written in place.  The JAX package's ``batch["update_mask"]``
    gates recurrent state only (ssm/hybrid, ROADMAP items 12c/12d);
    positional KV caches need none (see ``launch/serve.py``'s transient-row
    invariant), so the dense family takes no mask."""
    _dense_only(cfg)
    return tf_mod.lm_decode_step(params, cfg, batch["tokens"], batch["pos"], batch["cache"])


# families with a bulk prefill in the JAX package; the serving runtime
# falls back to token-wise warmup for the others
BULK_PREFILL_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def prefill(cfg: ArchConfig, params, tokens, *, max_len: int):
    """Bulk prefill: tokens [B, S] -> (logits [B, S, V], decode cache shaped
    like ``cache_specs(cfg, B, max_len)`` with positions 0..S-1 populated),
    the same state as S ``decode_step`` calls in one forward."""
    _dense_only(cfg)
    return tf_mod.lm_prefill(params, cfg, tokens, max_len=max_len)


def scatter_cache(cfg: ArchConfig, cache, slot: int, part):
    """Write a B=1 prefill cache into batch row ``slot`` of a serving cache,
    in place (leaves are [L, B, ...]); other rows are untouched."""
    _dense_only(cfg)

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


def binarize_model_params(cfg: ArchConfig, params, *, qc=None):
    """Convert every eligible linear's fp weights to packed-binary form.

    Eligible = dict leaves holding a 2D 'w' under a path not excluded in
    BINARIZE_EXCLUDE.  Stacked-layer weights ([L, K, N]) are binarized layer
    by layer and stacked, as the JAX package's vmap does.
    """
    qc = qc or cfg.quant

    def convert(path, subtree):
        if not isinstance(subtree, dict):
            return subtree
        pstr = "/".join(path)
        w = subtree.get("w")
        if isinstance(w, torch.Tensor) and not any(e in pstr for e in BINARIZE_EXCLUDE):
            if w.ndim == 2:
                return bl.binarize_params(subtree, qc)
            if w.ndim == 3:
                stacked = cm.stack_trees([bl.binarize_params({"w": wi}, qc) for wi in w])
                if "b" in subtree:
                    stacked["b"] = subtree["b"]
                return stacked
        return {k: convert(path + (k,), v) for k, v in subtree.items()}

    return convert((), params)


def count_params(cfg: ArchConfig) -> int:
    """Parameter count of ``init_params(cfg)``, from the config alone."""
    _dense_only(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = d * q + 2 * d * kv + q * d
    if cfg.qkv_bias:
        attn += q + 2 * kv
    if cfg.qk_norm:
        attn += 2 * hd
    ffn = (3 if cfg.activation in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    tables = (1 if cfg.tie_embeddings else 2) * cfg.vocab * d
    return cfg.n_layers * (attn + ffn + 2 * d) + tables + d
