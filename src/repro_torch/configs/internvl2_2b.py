"""internvl2-2b [vlm] — arXiv:2404.16821.  InternViT frontend (STUB:
precomputed patch embeddings arrive as inputs) + InternLM2-1.8B backbone."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92_553,
    activation="swiglu",
    n_image_tokens=256,
    rope_theta=1_000_000.0,
)
