"""mamba2-2.7b [ssm] — arXiv:2405.21060.  SSD (state-space duality),
attention-free; O(1)-state decode runs long_500k trivially."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    tie_embeddings=True,
)
