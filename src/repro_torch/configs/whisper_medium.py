"""whisper-medium [audio] — arXiv:2212.04356.  Enc-dec; the conv/mel frontend
is a STUB (precomputed frame embeddings [B, 1500, d] as inputs)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    encoder_len=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51_865,
    activation="gelu",
    tie_embeddings=True,
)
