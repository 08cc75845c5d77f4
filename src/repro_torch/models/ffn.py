"""Dense FFN blocks: SwiGLU / GeGLU / GELU-MLP (port of ``repro/models/ffn.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm


def init_ffn(gen: torch.Generator, cfg: ArchConfig, d_ff: int | None = None, *,
             device="cuda") -> dict:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    device = resolve_device(device)
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": cm.init_linear(gen, cfg.d_model, d_ff, dt, device=device),
            "w_up": cm.init_linear(gen, cfg.d_model, d_ff, dt, device=device),
            "w_down": cm.init_linear(gen, d_ff, cfg.d_model, dt, device=device),
        }
    return {
        "w_up": cm.init_linear(gen, cfg.d_model, d_ff, dt, device=device),
        "w_down": cm.init_linear(gen, d_ff, cfg.d_model, dt, device=device),
    }


def _gelu(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")   # jax.nn.gelu(approximate=True)


def ffn_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    q = cfg.quant
    if "w_gate" in params:
        act = F.silu if cfg.activation == "swiglu" else _gelu
        h = act(cm.linear(params["w_gate"], x, q)) * cm.linear(params["w_up"], x, q)
    else:
        h = _gelu(cm.linear(params["w_up"], x, q))
    # "seq" where the JAX package names None: the same placements unless the
    # sequence-sharded rules split the sequence, when w_down, like every
    # linear, runs on the rank's own sequence rows
    h = cm.shard(h, "batch", "seq", "ff")
    return cm.linear(params["w_down"], h, q)
