"""Shared model components: norms, RoPE, embeddings, quantized linears
(port of ``repro/models/common.py``).

Every weight-bearing matmul goes through ``core/binlinear.apply_linear``, so
the paper's multi-level binary approximation is a config switch on every
layer.  Param trees are nested dicts of tensors; ``tree_map``,
``tree_index`` and ``stack_trees`` stand in for ``jax.tree.map`` over them.
The JAX package's mesh constraints (``set_axis_rules``, ``shard``) wait for
``distributed/`` (ROADMAP item 10): the port's functions make no such call.

Weights are drawn from a ``torch.Generator`` on the generator's own device
and then moved to ``device``: a CPU generator gives the same weights on
every device, a CUDA one draws on the card.  Every ``init_*`` places its
tensors on ``device="cuda"`` unless told otherwise and raises when there is
no card.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import binlinear as bl


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts, keys in sorted order (``jax.tree.leaves``'s
    order, so the two packages list a tree's leaves alike)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_index(tree, i: int):
    """Entry ``i`` of every stacked ``[L, ...]`` leaf (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def stack_trees(trees: list):
    """Stack same-structured trees leaf by leaf into ``[L, ...]`` leaves."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=resolve_device(device))}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def rms_norm_gated(params, x: torch.Tensor, z: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(z)) * scale, in fp32, cast back
    to x's dtype."""
    xf = x.to(torch.float32) * torch.nn.functional.silu(z.to(torch.float32))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd], positions: [B, S] (or [S]) -> rotated x."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)          # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs      # [B, S, hd/2]
    cos = torch.cos(angles)[..., None, :]                        # [B, S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Fixed sinusoidal embeddings [length, dim] in fp32 (the Whisper
    encoder's positions; the caller casts them to the config dtype)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = 1.0 / (10_000 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Linear / embedding (quantization-aware)
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, in_dim: int, out_dim: int, dtype, *,
                bias: bool = False, device="cuda") -> dict:
    p = bl.init_linear(gen, in_dim, out_dim, dtype=dtype, device=device)
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=p["w"].device)
    return p


def linear(params, x: torch.Tensor, quant: bl.QuantConfig = bl.DENSE) -> torch.Tensor:
    return bl.apply_linear(params, x, quant)


def layer_quant_cfg(cfg, idx: int):
    """Resolve a per-layer §IV-D quant schedule for decoder layer ``idx``.

    With ``cfg.quant.m_schedule`` set, returns ``cfg`` specialized to that
    layer's level count (entry ``idx``, last entry extended if the schedule
    is short); otherwise returns ``cfg`` unchanged.
    """
    sched = cfg.quant.m_schedule
    if sched is None:
        return cfg
    m = sched[idx] if idx < len(sched) else sched[-1]
    return cfg.replace(quant=cfg.quant.replace(m_active=int(m), m_schedule=None))


def init_embedding(gen: torch.Generator, vocab: int, dim: int, dtype,
                   device="cuda") -> dict:
    return {"table": bl.init_linear(gen, vocab, dim, dtype, scale=0.02, device=device)["w"]}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss numerics)."""
    return x.to(torch.float32) @ params["table"].to(torch.float32).T


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def causal_mask(S: int, window: int | None = None, device=None) -> torch.Tensor:
    """[S, S] bool; True = attend.  window = sliding-window width."""
    q = torch.arange(S, device=device)[:, None]
    k = torch.arange(S, device=device)[None, :]
    m = k <= q
    if window is not None:
        m &= (q - k) < window
    return m


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)
