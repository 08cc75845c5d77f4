"""deepseek-v3-671b [moe] — arXiv:2412.19437.  MLA, 1 shared + 256 routed
experts (top-8), 3 leading dense layers, MTP head."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # leading dense layers
    d_ff_expert=2048,       # routed + shared expert width
    vocab=129_280,
    activation="swiglu",
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    n_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
)
