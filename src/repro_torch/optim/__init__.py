from repro_torch.optim.optimizers import Optimizer, adamw, clip_by_global_norm, sgd
from repro_torch.optim.schedule import cosine_schedule, exponential_decay, warmup_cosine

__all__ = [
    "Optimizer", "adamw", "clip_by_global_norm", "cosine_schedule",
    "exponential_decay", "sgd", "warmup_cosine",
]
