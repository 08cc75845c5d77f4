"""h2o-danube-1.8b [dense] — arXiv:2401.16818.  llama+mistral mix, SWA.

Sliding-window attention makes this arch sub-quadratic: it runs the
long_500k decode cell with a rolling window cache.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32_000,
    activation="swiglu",
    sliding_window=4096,
    rope_theta=10_000.0,
)
