"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B.  qwen1.5 arch (qkv bias,
kv=32 i.e. full MHA)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92_416,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
