"""Architecture config schema and registry (port of ``repro/configs/base.py``).

Every ported architecture has one ``configs/<id>.py`` exporting ``CONFIG``
(the JAX package's file with its import pointed here); ``get_config(name)``
resolves it and ``reduced(cfg)`` shrinks it for CPU tests.  ``ArchConfig``
holds the JAX package's fields that the dense, MoE, SSM (Mamba2), hybrid
(Zamba2), enc-dec (Whisper) and VLM (InternVL2) families read, under the
same names and defaults, and the two training knobs (``remat``,
``onehot_loss``); the JAX package's sharding knobs come with
``distributed/``.  The dry run's shape cells
and input specs (``SHAPES``, ``input_specs``, ``cells``) are not ported yet
(ROADMAP item 14).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.core.binlinear import QuantConfig

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

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


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
