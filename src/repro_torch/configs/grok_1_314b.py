"""grok-1-314b [moe] — hf:xai-org/grok-1.  8 experts, top-2, GQA kv=8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    d_ff_expert=32768,
    vocab=131_072,
    activation="geglu",
    n_experts=8,
    top_k=2,
    logit_softcap=30.0,
)
