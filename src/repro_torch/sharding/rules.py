"""Sharding rules: parameter + activation partitioning for every arch family
(port of ``repro/sharding/rules.py``).

Mesh axes:
  * single-pod:  ("data", "model")          = 16 x 16  (256 devices)
  * multi-pod:   ("pod", "data", "model")   = 2 x 16 x 16 (512 devices)

Strategy (the JAX package's):
  * TP   — attention heads / FFN hidden / experts / vocab on "model".
  * FSDP — every parameter's largest non-TP dim additionally sharded over
           the DP domain ("pod"+"data") — ZeRO-3; optimizer state likewise.
  * DP   — batch over ("pod", "data"); SP — sequence over "data" for the
           batch=1 long-context cells.

Rules are *pattern -> PartitionSpec* over parameter tree paths; first match
wins; unmatched leaves are replicated (biases, norms, scalars).  The specs
are the port's own :class:`PartitionSpec`, a tuple with one entry per
tensor dim (``None``, an axis name, or a tuple of axis names), equal entry
by entry to the JAX package's.  ``mesh`` is a ``DeviceMesh`` or a mapping
``{axis name: size}`` (the rules read only the axis sizes), so the specs of
a production mesh are computed without its devices.  ``param_placements``
and ``distribute_params`` put the specs onto a ``DeviceMesh`` as DTensor
placements (the JAX package's ``NamedSharding``).
"""
from __future__ import annotations

import math
import re
from typing import TYPE_CHECKING

from repro_torch.sharding.placement import NamedSharding, place, spec_placements

if TYPE_CHECKING:
    from repro_torch.configs.base import ArchConfig


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry per leading
    tensor dim, ``P()`` replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or of a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _axes_product(axes, sizes: dict[str, int]) -> int:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(sizes[a] for a in names)


# Each entry: (regex over 'path', [candidate specs — first that divides the
# leaf's dims wins]).  Weight matrices are [in, out].
def _param_rules(cfg: "ArchConfig", mesh, fsdp: bool = True):
    dp = dp_axes(mesh) if fsdp else None
    rules: list[tuple[str, list[P]]] = [
        # embeddings / unembeddings: vocab on model, d_model FSDP
        (r"(embed|unembed)/table", [P("model", dp), P(dp, "model"), P(dp, None)]),
        # MoE experts: expert dim on model (EP); fallback = TP over hidden
        # (grok: 8 experts < 16-way model axis -> TP inside experts)
        (r"moe/w_(gate|up)$", [P("model", dp, None), P(None, dp, "model")]),
        (r"moe/w_down$", [P("model", None, dp), P(None, "model", dp)]),
        (r"moe/router/w", [P()]),
        # attention projections: fused head dim on model, d_model FSDP
        (r"attn/w(q|k|v)/w", [P(dp, "model"), P(dp, None)]),
        (r"attn/wo/w", [P("model", dp), P(None, dp)]),
        (r"attn/w(q|k|v)/b", [P("model"), P()]),
        # MLA factors
        (r"attn/wdq/w", [P(dp, "model")]),
        (r"attn/wuq/w", [P(dp, "model")]),
        (r"attn/wdkv/w", [P(dp, None)]),
        (r"attn/wu(k|v)/w", [P(dp, "model")]),
        # FFN: hidden on model, d_model FSDP
        (r"(ffn|shared)/w_(gate|up)/w", [P(dp, "model")]),
        (r"(ffn|shared)/w_down/w", [P("model", dp)]),
        # Mamba2 projections: d_inner on model
        (r"block/in_proj/w", [P(dp, "model")]),
        (r"block/out_proj/w", [P("model", dp)]),
        (r"block/conv_w", [P(None, "model"), P()]),
        (r"block/conv_b", [P("model"), P()]),
        # hybrid shared block input projection
        (r"shared/in_proj/w", [P(dp, "model")]),
        # MTP projection
        (r"mtp/proj/w", [P(dp, "model")]),
        # packed-binary deployment weights: [M, K/8, N] (+ leading stack dim)
        # out-dim on model (TP), packed-K FSDP; alphas [M, G, N] follow N
        (r"/B_packed$", [P(None, dp, "model"), P(None, None, "model"),
                         P(None, dp, None), P()]),
        (r"/alpha$", [P(None, None, "model"), P()]),
    ]
    return rules


def _spec_divides(spec: P, shape, mesh) -> bool:
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, axes in zip(shape, entries):
        if axes is not None and dim % _axes_product(axes, sizes) != 0:
            return False
    return True


def _fit_spec(spec: P, ndim: int) -> P:
    specs = list(spec)
    while len(specs) < ndim:          # stacked-layer leading axes -> None
        specs.insert(0, None)
    if len(specs) > ndim:
        specs = specs[len(specs) - ndim:]
    return P(*specs)


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts, the path the keys joined by
    ``/`` (the JAX package's ``_leaf_path_str`` for dict trees)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(cfg: "ArchConfig", params_tree, mesh, *, fsdp: bool = True):
    """PartitionSpec tree for a parameter tree (stacked layer dims get a
    leading None automatically — detected by rank vs rule arity)."""
    rules = _param_rules(cfg, mesh, fsdp)

    def spec_for(pstr, leaf):
        for pat, candidates in rules:
            if re.search(pat, pstr):
                for cand in candidates:
                    fitted = _fit_spec(cand, len(leaf.shape))
                    if _spec_divides(fitted, leaf.shape, mesh):
                        return fitted
                return P()  # nothing divides -> replicate
        return P()  # replicate (biases, norms, scalars)

    return tree_map_with_path(spec_for, params_tree)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: "ArchConfig", batch_tree, mesh, *, seq_sharded: bool = False):
    """tokens/labels: batch over DP axes (seq over 'data' when batch==1 SP);
    cache: batch over DP, heads over model."""
    dp = dp_axes(mesh)
    dp_size = _axes_product(dp, axis_sizes(mesh))
    # actual batch size, to disambiguate the stacked-layer dim in caches
    tokens = batch_tree.get("tokens") if isinstance(batch_tree, dict) else None
    global_batch = tokens.shape[0] if tokens is not None else None

    def spec_for(pstr, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if "cache" in pstr:
            return _cache_spec(cfg, pstr, shape, mesh, global_batch)
        if pstr.endswith("pos"):
            return P(dp) if shape and shape[0] % dp_size == 0 else P()
        if "tokens" in pstr or "labels" in pstr:
            if shape[0] % dp_size == 0:
                return P(dp, *([None] * (ndim - 1)))
            if seq_sharded and ndim >= 2:
                return P(None, "data", *([None] * (ndim - 2)))
            return P()
        if "embeds" in pstr:  # patch/frame stubs: [B, S, D]
            if shape[0] % dp_size == 0:
                return P(dp, None, None)
            return P()
        return P()

    return tree_map_with_path(spec_for, batch_tree)


def _cache_spec(cfg: "ArchConfig", pstr: str, shape, mesh, global_batch: int | None = None):
    """KV / SSM cache sharding: leading stacked-layer dim unsharded; batch on
    DP when divisible; kv-head dim on model when divisible."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dp_size = _axes_product(dp, sizes)
    model_size = sizes["model"]
    spec: list = [None] * len(shape)
    # the batch dim: matched by size when known (disambiguates the stacked
    # layer dim), else the first plausible leading dim
    for i, d in enumerate(shape[:2]):
        if global_batch is not None and d != global_batch:
            continue
        if d % dp_size == 0 and d >= dp_size:
            spec[i] = dp
            break
    # head dim: size == n_kv_heads or n_heads and divisible by model axis
    # (index 0 excluded — it's the stacked-layer dim, which can collide by
    # value, e.g. codeqwen's 32 layers == 32 kv heads)
    for i, d in enumerate(shape):
        if i == 0:
            continue
        if spec[i] is None and d in (cfg.n_kv_heads, cfg.n_heads) and d and \
                d % model_size == 0:
            spec[i] = "model"
            break
    else:
        # SSM state: shard the (large) d_inner-derived head dim on model
        matched = False
        if cfg.ssm_state and len(shape) >= 3:
            H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
            for i, d in enumerate(shape):
                if i == 0:
                    continue
                if spec[i] is None and d == H and d % model_size == 0:
                    spec[i] = "model"
                    matched = True
                    break
        if not matched and len(shape) >= 3 and cfg.kv_seq_shard:
            # sequence-sharded KV cache: shard the largest (seq) dim over
            # 'model' — scores partition over keys
            cands = [(d, i) for i, d in enumerate(shape)
                     if spec[i] is None and d >= 1024 and d % model_size == 0]
            if cands:
                matched = True
                spec[max(cands)[1]] = "model"
        if not matched and len(shape) >= 3:
            # kv-head count not divisible by the model axis (MQA/GQA<16) or
            # latent cache (MLA): shard the trailing feature dim on 'model'
            # instead — storage-sharded KV; attention contracts it with a
            # partial-sum all-reduce.
            d = shape[-1]
            if d % model_size == 0 and d >= model_size:
                spec[-1] = "model"
    # huge sequence dim (long-context cache, batch==1): shard over 'data'
    used = {a for s in spec if s for a in ((s,) if isinstance(s, str) else s)}
    if "data" not in used:
        for i, d in enumerate(shape):
            if spec[i] is None and d >= 8192 and d % sizes["data"] == 0:
                spec[i] = "data"
                break
    return P(*spec)


def activation_rules(mesh, *, seq_sharded: bool = False) -> dict:
    """Logical-axis rules installed via models.common.set_axis_rules."""
    dp = dp_axes(mesh)
    return {
        "batch": dp,
        "seq": "data" if seq_sharded else None,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "vocab": "model",
    }


# ---------------------------------------------------------------------------
# DTensor placements (NamedSharding's counterpart)
# ---------------------------------------------------------------------------

def _map_specs(fn, specs, *trees):
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    return {k: _map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}


def param_placements(specs, mesh):
    """A spec tree -> the same tree of :class:`NamedSharding` (the mesh and
    its placements): a dim sharded over ``("pod", "data")`` is ``Shard(dim)``
    on both mesh dims, in mesh order; an unnamed mesh dim is
    ``Replicate()``."""
    return _map_specs(lambda s: NamedSharding(mesh, spec_placements(s, mesh)), specs)


def distribute_params(tree, specs, mesh):
    """Every leaf of ``tree`` (the same tensor on every rank) placed onto the
    mesh by its spec; each rank keeps its own shard, cut from its own copy
    with no communication."""
    return _map_specs(lambda s, t: place(t, mesh, spec_placements(s, mesh)), specs, tree)
