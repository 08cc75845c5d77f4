"""qwen3-14b [dense] — hf:Qwen/Qwen3 family.  qk_norm, GQA kv=8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151_936,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
)
