"""zamba2-7b [hybrid] — arXiv:2411.15242.  Mamba2 backbone + shared attention
block (one parameter set, applied every 6 mamba blocks on
concat(hidden, original embedding)).  Sub-quadratic family: runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32_000,
    activation="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    hybrid_attn_every=6,
)
