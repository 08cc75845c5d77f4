"""Shared model components: norms, RoPE, embeddings, quantized linears
(port of ``repro/models/common.py``).

Every weight-bearing matmul goes through ``core/binlinear.apply_linear``, so
the paper's multi-level binary approximation is a config switch on every
layer.  Param trees are nested dicts of tensors; ``tree_map``,
``tree_index`` and ``stack_trees`` stand in for ``jax.tree.map`` over them.
Activation sharding uses *logical* axis names resolved against rules
installed by the launcher (``set_axis_rules``, from ``launch/steps.py``'s
``install_rules``); ``shard`` then moves a DTensor activation to the
placements the rules give, and is a no-op on a plain tensor or without
rules, as the JAX package's is on one device.

Weights are drawn from a ``torch.Generator`` on the generator's own device
and then moved to ``device``: a CPU generator gives the same weights on
every device, a CUDA one draws on the card.  Every ``init_*`` places its
tensors on ``device="cuda"`` unless told otherwise and raises when there is
no card.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch import resolve_device
from repro_torch.core import binlinear as bl
from repro_torch.sharding import placement as pl
from repro_torch.sharding.rules import PartitionSpec

_STATE = threading.local()


def set_axis_rules(rules: dict | None, axis_sizes: dict[str, int] | None = None) -> None:
    """Install logical->mesh axis rules (e.g. {'batch': ('pod', 'data')}).
    axis_sizes enables divisibility checks (a constraint that doesn't divide
    the dim is dropped rather than failing)."""
    _STATE.rules = rules
    _STATE.axis_sizes = axis_sizes or {}


def get_axis_rules():
    return getattr(_STATE, "rules", None)


def _axes_size(axes, sizes: dict[str, int]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes.get(axes, 1)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def logical_spec(shape, logical, rules: dict, sizes: dict[str, int]) -> PartitionSpec:
    """The PartitionSpec ``shard`` constrains to: each logical name resolved
    through ``rules``, dropped where its axes do not divide the dim."""
    spec = []
    for i, name in enumerate(logical):
        axes = rules.get(name) if name else None
        if axes is not None and shape[i] % _axes_size(axes, sizes) != 0:
            axes = None  # dim not divisible -> leave unconstrained
        spec.append(axes)
    return PartitionSpec(*spec)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names: a DTensor is
    redistributed to the spec's placements (a dim named by no rule is
    replicated), its local shard made contiguous (a dim that splits
    unevenly comes back as a narrowed view, which a later view of the
    shard cannot take); no-op without rules or on a plain tensor."""
    rules = get_axis_rules()
    if rules is None or not pl.is_dtensor(x):
        return x
    spec = logical_spec(x.shape, logical, rules, getattr(_STATE, "axis_sizes", {}))
    return pl.contiguous_local(x.redistribute(x.device_mesh,
                                              pl.spec_placements(spec, x.device_mesh)))


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


@contextlib.contextmanager
def cache_layer(tree, i: int):
    """Entry ``i`` of every stacked cache leaf, for a decode step to write
    in place; on exit each entry that is not a view of its stacked leaf (a
    DTensor split on the stacked dim) is written back
    (``placement.write_stacked``)."""
    layer = tree_index(tree, i)
    yield layer
    tree_map(lambda t, v: pl.write_stacked(t, i, v), tree, layer)


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
    """``table[tokens]``; over a DTensor table, the vocab-parallel lookup
    of ``sharding/placement.embedding``."""
    table = params["table"]
    if pl.is_dtensor(table):
        return pl.embedding(tokens, table)
    return F.embedding(tokens, table)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss numerics).  Over DTensors, where ``x`` is split
    over its sequence on ``"model"`` (the SSM and hybrid residual) or the
    table is whole on every rank (a vocab the model axis does not divide),
    each rank multiplies its own rows of ``x`` by the whole table
    (``placement.rows_times_whole``; a vocab-split table is gathered): the
    logits keep ``x``'s rows and the loss needs no gather of the vocab."""
    table = params["table"]
    if pl.is_dtensor(x) and pl.is_dtensor(table) and x.ndim > 1 and all(
            isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim < x.ndim - 1)
            for p in x.placements):
        m = pl.model_dim(x.device_mesh)
        if all(isinstance(p, Replicate) for p in table.placements) or (
                m is not None and isinstance(x.placements[m], Shard)):
            whole = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)
            return pl.rows_times_whole(x.to(torch.float32), whole.to(torch.float32).T)
    return x.to(torch.float32) @ table.to(torch.float32).T


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
