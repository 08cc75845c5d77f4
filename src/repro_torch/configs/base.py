"""Architecture config schema, registry and input specs (port of
``repro/configs/base.py``).

Every ported architecture has one ``configs/<id>.py`` exporting ``CONFIG``
(the JAX package's file with its import pointed here); ``get_config(name)``
resolves it and ``reduced(cfg)`` shrinks it for CPU tests.  ``ArchConfig``
holds the JAX package's fields that the dense, MoE, SSM (Mamba2), hybrid
(Zamba2), enc-dec (Whisper) and VLM (InternVL2) families read, under the
same names and defaults, the two training knobs (``remat``,
``onehot_loss``) and the two sharding knobs (``serve_fsdp``,
``kv_seq_shard``, read by ``sharding/rules.py`` and
``launch/steps.build_serve_step``).  ``SHAPES`` and ``input_specs(cfg,
shape)`` give the shape cells' model inputs as ``meta`` tensors (shape and
dtype only, the JAX package's ``ShapeDtypeStruct``s), and ``cells(cfg)``
the shape cells the dry run (``launch/dryrun.py``) lowers for an arch.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.core.binlinear import QuantConfig

# ---------------------------------------------------------------------------
# Shape cells (the JAX package's): seq_len x global_batch
# ---------------------------------------------------------------------------
SHAPES: dict[str, dict] = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}

ARCH_IDS = ["gemma_2b", "qwen3_14b", "h2o_danube_1_8b", "codeqwen15_7b",
            "zamba2_7b", "mamba2_2_7b", "grok_1_314b", "deepseek_v3_671b",
            "whisper_medium", "internvl2_2b"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # default d_model // n_heads
    activation: str = "swiglu"       # swiglu | geglu | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int | None = None  # SWA width; None = full attention
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int | None = None
    n_dense_layers: int = 0          # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    q_lora_rank: int = 0             # 0 = no q compression
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MTP (DeepSeek) ---
    mtp_depth: int = 0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Zamba2) ---
    hybrid_attn_every: int = 6       # one shared attn block per N ssm blocks
    # --- enc-dec (Whisper) ---
    n_encoder_layers: int = 0
    encoder_len: int = 1500          # precomputed frame embeddings (stub)
    # --- VLM (InternVL2) ---
    n_image_tokens: int = 0          # precomputed patch embeddings (stub)
    # --- numerics / quant ---
    dtype: str = "bfloat16"
    quant: QuantConfig = QuantConfig(mode="dense")
    remat: bool = True               # recompute each layer's forward in backward
    attn_chunk: int | None = None    # query-chunked attention (flash-style)
    onehot_loss: bool = False        # CE as logsumexp minus a one-hot contraction
    # --- sharding knobs (the JAX package's) ---
    serve_fsdp: bool = True          # False: TP-only params at serve time
    kv_seq_shard: bool = False       # decode cache: shard seq dim on 'model'
                                     # (vs head_dim) when kv heads don't
                                     # divide the model axis

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode? (SSM/hybrid/SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for MODEL_FLOPS = 6*N*D roofline term) ----------
    def param_count(self, active_only: bool = False) -> int:
        from repro_torch.models import api

        return api.count_params(self, active_only=active_only)


def get_config(name: str) -> ArchConfig:
    mod_name = name.replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown config {name!r} (known: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU tests (the JAX package's cuts)."""
    kw = dict(
        n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128, vocab=512, head_dim=16,
        sliding_window=32 if cfg.sliding_window else None, remat=False,
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff_expert=64,
                  n_dense_layers=min(cfg.n_dense_layers, 1))
    if cfg.use_mla:
        kw.update(q_lora_rank=32 if cfg.q_lora_rank else 0, kv_lora_rank=32,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16, n_layers=4)
    if cfg.family == "hybrid":
        kw.update(hybrid_attn_every=2, n_layers=4)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2, encoder_len=24)
    if cfg.n_image_tokens:
        kw.update(n_image_tokens=8)
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no storage)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """Every model input of this (arch, shape) cell as a ``meta`` tensor.

    train/prefill: full-sequence batch. decode: one new token + KV/SSM cache
    of seq_len.  Modality frontends are stubs: precomputed embeddings appear
    as inputs (the VLM's patch and the enc-dec's frame embeddings).
    """
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    dt = cfg.torch_dtype
    if sh["kind"] in ("train", "prefill"):
        specs = {"tokens": _spec((B, S), torch.int32)}
        if sh["kind"] == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = _spec((B, cfg.n_image_tokens, cfg.d_model), dt)
        if cfg.family == "encdec":
            specs["frame_embeds"] = _spec((B, cfg.encoder_len, cfg.d_model), dt)
        return specs
    from repro_torch.models import api   # api -> models -> this module
    from repro_torch.models.common import tree_map

    # (vlm patch / encdec frame context lives inside the cache at decode time)
    return {"tokens": _spec((B, 1), torch.int32), "pos": _spec((B,), torch.int32),
            "cache": tree_map(lambda s: _spec(s.shape, s.dtype),
                              api.cache_specs(cfg, batch=B, max_len=S))}


def cells(cfg: ArchConfig) -> list[str]:
    """The shape cells this arch runs (long_500k only if sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
