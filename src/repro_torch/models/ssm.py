"""Mamba2 / SSD (state-space duality) blocks, arXiv:2405.21060 (port of
``repro/models/ssm.py``).

Training and prefill use the chunked SSD algorithm (quadratic within a
chunk, linear across chunks); decode is the O(1) recurrent state update.
The large projections (``in_proj``/``out_proj``) go through the quantizable
linear, so in binary mode they run on the ``binary_matmul`` kernel; the
dynamics (``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``) stay fp32
whatever the dtype, and the scan runs in fp32.

The SSD products are plain torch ops, as the JAX package's are plain
``jnp`` outside any Pallas kernel.  Its 4-operand einsums are written as
pairwise contractions in one fixed order, so the CPU and the card sum
alike.  ``mamba2_decode`` writes the cache in place (the JAX package
returns a new one): the new state is computed from the old cache first,
then ``torch.where(update_mask, new, old)`` is copied back, so a masked row
keeps its bits.

Over a mesh (DTensor activations, ``launch/steps.py``) everything from the
split of ``in_proj``'s output to the gated norm runs on plain local tensors
(:class:`_Part`): each rank takes its batch rows, as the mesh dims other
than ``"model"`` split them, and its SSM heads where ``"model"`` divides
them (the JAX rules put the state's heads on ``"model"``); B and C (one
group) are whole on every rank.  ``in_proj``'s column split does not line
up with its ``[z, x, B, C, dt]`` segments, so each rank gathers the
projection's columns whole over ``"model"`` and keeps its heads' z, x and
dt columns and all of B and C; the depth-wise conv, per channel, runs on
those channels.  y and z go back as DTensors split on ``"model"`` by head
for the gated norm and ``out_proj``, whose product is then a partial sum
over ``"model"``: a full-sequence block reduce-scatters it over the
sequence (``split_sequence``), so the residual stream after it, and the
norms and the LM head, run on each model rank's tokens; the block puts
its input back on the batch's rows (``common.shard``), which also gathers
that split.  The
decode's state is read from and written to the cache's own shard where the
cache is placed as the part (its heads on ``"model"``), else moved there
and back.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import attention as attn
from repro_torch.sharding import placement as pl


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, H, conv_ch


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    d_inner, H, conv_ch = _dims(cfg)
    dt = cfg.torch_dtype
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    proj_out = 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + H  # z, x, B, C, dt
    conv_w = torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen, device=gen.device)
    return {
        "in_proj": cm.init_linear(gen, cfg.d_model, proj_out, dt, device=dev),
        "out_proj": cm.init_linear(gen, d_inner, cfg.d_model, dt, device=dev),
        "conv_w": (conv_w * 0.1).to(**f32),
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": cm.init_rmsnorm(d_inner, dt, device=dev),
    }


def init_mamba_layers(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """``cfg.n_layers`` of {norm, block} stacked into ``[L, ...]`` leaves (the
    ssm LM's and the hybrid's backbone)."""
    dev = resolve_device(device)
    return cm.stack_trees([{"norm": cm.init_rmsnorm(cfg.d_model, cfg.torch_dtype, device=dev),
                            "block": init_mamba2(gen, cfg, device=dev)}
                           for _ in range(cfg.n_layers)])


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_inner, H, _ = _dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner, gn, gn, H], dim=-1)   # z, x, B, C, dt


def _causal_dconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depth-wise causal conv + SiLU, x: [B, L, ch], w: [width, ch] -> [B, L, ch]."""
    width, L = w.shape[0], x.shape[1]
    pad = F.pad(x.to(torch.float32), (0, 0, width - 1, 0))
    y = torch.zeros_like(pad[:, :L])
    for i in range(width):
        y = y + pad[:, i: i + L] * w[i]
    return F.silu(y + b).to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., q] -> [..., q, q]; [i, j] = sum_{j<k<=i} x_k, -inf above the
    diagonal (masked before any exp: the upper triangle would overflow)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, Bm, Cm, D, chunk: int, *, return_state: bool = False):
    """Chunked SSD scan (Mamba2 Listing 1).

    xh: [b, l, h, p]  dt: [b, l, h]  A: [h] (negative)
    Bm, Cm: [b, l, g, n] (g groups broadcast over heads)  D: [h]
    returns y: [b, l, h, p] fp32; with ``return_state`` also the recurrent
    state after the last token ([b, h, p, n] fp32, the decode ``ssm_state``).

    Heads are factored as h = g x e and B/C keep their group dim: no repeat
    over heads.  The JAX package's 3- and 4-operand einsums are contracted
    pairwise here: C·B over n first, then the decay, then x over s.
    """
    b, l, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    e = h // g
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {chunk}")
    c = l // chunk
    f32 = torch.float32
    xf, dtf = xh.to(f32), dt.to(f32)
    dA = dtf * A[None, None, :]                                  # [b, l, h]
    x_dt = xf * dtf[..., None]                                   # dt-premultiplied

    xc = x_dt.reshape(b, c, chunk, g, e, p)                      # [b,c,q,g,e,p]
    dAc = dA.reshape(b, c, chunk, g, e)                          # [b,c,q,g,e]
    Bc = Bm.to(f32).reshape(b, c, chunk, g, n)                   # [b,c,q,g,n]
    Cc = Cm.to(f32).reshape(b, c, chunk, g, n)
    dA_cs = torch.cumsum(dAc, dim=2)                             # [b,c,q,g,e]
    # --- intra-chunk (diagonal blocks) ---
    Lm = torch.exp(_segsum(dAc.movedim(2, -1)))                  # [b,c,g,e,l,s]
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)              # [b,c,g,l,s]
    Y_diag = torch.einsum("bcgels,bcsgep->bclgep", CB[:, :, :, None] * Lm, xc)
    # --- chunk final states ---
    decay_states = torch.exp(dA_cs[:, :, -1:] - dA_cs)           # [b,c,q,g,e]
    states = torch.einsum("bcsgep,bcsgn->bcgepn", xc * decay_states[..., None], Bc)
    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(dA_cs[:, :, -1])                     # [b,c,g,e]
    carry = torch.zeros((b, g, e, p, n), dtype=f32, device=xh.device)
    prev = []
    for i in range(c):
        prev.append(carry)                                       # the state BEFORE chunk i
        carry = carry * chunk_decay[:, i, ..., None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                       # [b,c,g,e,p,n]
    # --- state -> output ---
    state_decay = torch.exp(dA_cs)                               # [b,c,q,g,e]
    Y_off = torch.einsum("bclgn,bcgepn->bclgep", Cc, prev_states) * state_decay[..., None]
    y = (Y_diag + Y_off).reshape(b, l, h, p)
    y = y + xf * D[None, None, :, None]
    if return_state:
        return y, carry.reshape(b, h, p, n)
    return y


@dataclasses.dataclass(frozen=True)
class _Part:
    """The part of a Mamba2 block's scan that this rank computes: its batch
    rows (``rows``: per mesh dim ``Shard(0)`` or ``Replicate()``) and the
    SSM heads ``[h0, h1)``.  ``mesh`` None: plain tensors, every row and
    head, and every method the identity."""
    mesh: object
    rows: tuple
    h0: int
    h1: int
    split_heads: bool

    def placements(self, heads_dim=None) -> tuple:
        """A part's tensor's placements: its rows, and its heads dim on
        ``"model"`` where the heads are split (``heads_dim`` None: whole)."""
        m = pl.model_dim(self.mesh)
        return tuple(Shard(heads_dim) if i == m and self.split_heads and heads_dim is not None
                     else p for i, p in enumerate(self.rows))

    def local(self, t, heads_dim=None):
        """A batched ``t`` as the part's local tensor (its rows, and its
        heads where ``heads_dim`` names them; every other dim whole)."""
        if self.mesh is None:
            return t
        return pl.to_local_part(t, self.mesh, self.placements(heads_dim), self._split())

    def whole(self, t):
        """A parameter whole on every rank, as a local tensor whose gradient
        the ranks' parts sum."""
        if self.mesh is None:
            return t
        return pl.to_local_part(t, self.mesh, (Replicate(),) * self.mesh.ndim, self._split())

    def _split(self) -> tuple:
        m = pl.model_dim(self.mesh)
        return tuple(isinstance(p, Shard) or (i == m and self.split_heads)
                     for i, p in enumerate(self.rows))

    def back(self, t: torch.Tensor, shape, heads_dim=None):
        """The part's local ``t`` as the DTensor of global ``shape``."""
        if self.mesh is None:
            return t
        return pl.from_local(t, self.mesh, self.placements(heads_dim), shape)

    def write(self, dst, value: torch.Tensor, heads_dim=None) -> None:
        """Cache leaf ``dst`` set in place to the part's ``value``."""
        if self.mesh is None:
            dst.copy_(value)
        else:
            pl.write_part(dst, value, self.placements(heads_dim))

    def channels(self, t: torch.Tensor, cfg: ArchConfig):
        """The part's channels of a ``[..., conv_ch]`` tensor of the conv
        stream ``[x, B, C]``: its heads' x channels, then B and C whole."""
        d_inner, H, _ = _dims(cfg)
        if (self.h0, self.h1) == (0, H):
            return t
        p = cfg.ssm_head_dim
        return torch.cat([t[..., self.h0 * p: self.h1 * p], t[..., d_inner:]], dim=-1)


def _part(cfg: ArchConfig, x) -> _Part:
    """This rank's part of the scan over the block's input ``x``: all of it
    on a plain tensor; on a DTensor the rows ``x``'s batch is split into
    (the residual stream's: ``in_proj``'s output may come back whole on
    the data axes from an FSDP product), and the heads split on ``"model"``
    where it divides them and the block has one group (B and C are then
    whole on every rank)."""
    _, H, _ = _dims(cfg)
    if not pl.is_dtensor(x):
        return _Part(None, (), 0, H, False)
    mesh = x.device_mesh
    n = pl.model_size(mesh)
    if n == 1 or H % n or cfg.ssm_ngroups != 1:
        return _Part(mesh, pl.row_placements(x, batch_only=True), 0, H, False)
    r, k = mesh.get_local_rank(pl.model_dim(mesh)), H // n
    return _Part(mesh, pl.row_placements(x, batch_only=True), r * k, (r + 1) * k, True)


def _mamba2_seq(params, x: torch.Tensor, cfg: ArchConfig, *, want_cache: bool):
    """Shared full-sequence core of forward (train) and prefill (serve)."""
    B, L, _ = x.shape
    d_inner, H, conv_ch = _dims(cfg)
    n, g, hd = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_head_dim
    x = cm.shard(x, "batch", "seq", None)      # the residual's rows (its sequence gathered)
    proj = cm.linear(params["in_proj"], x, cfg.quant)
    part = _part(cfg, x)
    h0, h1 = part.h0, part.h1
    z, xh, Bm, Cm, dt_raw = _split_proj(cfg, part.local(proj))
    b, ci = xh.shape[0], (h1 - h0) * hd                          # local rows, x channels
    xBC_pre = torch.cat([xh, Bm, Cm], dim=-1)                    # pre-conv stream
    xBC = _causal_dconv(part.channels(xBC_pre, cfg),
                        part.channels(part.whole(params["conv_w"]), cfg),
                        part.channels(part.whole(params["conv_b"]), cfg))
    xh = xBC[..., :ci].reshape(b, L, h1 - h0, hd)
    Bm = xBC[..., ci: ci + g * n].reshape(b, L, g, n)
    Cm = xBC[..., ci + g * n:].reshape(b, L, g, n)
    # F.softplus returns v past 20, where fp32 rounds jax's logaddexp(v, 0) to v too
    dt = F.softplus(dt_raw[..., h0:h1].to(torch.float32) + part.whole(params["dt_bias"])[h0:h1])
    A = -torch.exp(part.whole(params["A_log"])[h0:h1])
    # the largest divisor of L that fits the configured chunk: any prompt
    # length works (a prime L degrades to chunk 1, still exact)
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:
        chunk -= 1
    y = ssd_chunked(xh, dt, A, Bm, Cm, part.whole(params["D"])[h0:h1], chunk,
                    return_state=want_cache)
    cache = None
    if want_cache:
        y, final_state = y
        # conv_state holds the last (width-1) *pre-activation* xBC rows, what
        # token-wise decode keeps (zero-padded when L < width-1)
        w1 = cfg.ssm_conv_width - 1
        conv_state = F.pad(xBC_pre, (0, 0, w1, 0))[:, L:]
        cache = {"ssm_state": part.back(final_state, (B, H, hd, n), heads_dim=1),
                 "conv_state": part.back(conv_state.to(cfg.torch_dtype), (B, w1, conv_ch))}
    y = part.back(y.reshape(b, L, ci).to(x.dtype), (B, L, d_inner), heads_dim=2)
    z = part.back(z[..., h0 * hd: h1 * hd], (B, L, d_inner), heads_dim=2)
    y = cm.rms_norm_gated(params["norm"], y, z, cfg.norm_eps)
    return split_sequence(cm.linear(params["out_proj"], y, cfg.quant)), cache


def split_sequence(x):
    """``x [B, L, D]`` on its batch rows and its sequence split on
    ``"model"`` where L divides (sequence parallelism): the block's output,
    a partial sum over ``"model"`` (each rank's heads' rows of
    ``out_proj``), is reduce-scattered, so the residual stream after the
    block, and the norms and the LM head after it, run on each model rank's
    tokens, not whole on every model rank.  A plain tensor, or a mesh
    without a ``"model"`` split, as it is."""
    if not pl.is_dtensor(x):
        return x
    mesh = x.device_mesh
    m, n = pl.model_dim(mesh), pl.model_size(mesh)
    if n == 1 or x.shape[1] % n:
        return x
    rows = pl.row_placements(x, batch_only=True)
    return x.redistribute(mesh, tuple(Shard(1) if i == m else p for i, p in enumerate(rows)))


def mamba2_forward(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: [B, L, D] -> [B, L, D]."""
    return _mamba2_seq(params, x, cfg, want_cache=False)[0]


def mamba2_prefill(params, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence block that also returns the decode cache (the state
    after token L-1): x [B, L, D] -> (y [B, L, D], cache)."""
    return _mamba2_seq(params, x, cfg, want_cache=True)


# --- decode -----------------------------------------------------------------

def mamba2_cache_specs(cfg: ArchConfig, batch: int) -> dict:
    _, H, conv_ch = _dims(cfg)
    return {"ssm_state": attn.CacheSpec((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                                        torch.float32),
            "conv_state": attn.CacheSpec((batch, cfg.ssm_conv_width - 1, conv_ch),
                                         cfg.torch_dtype)}


def init_mamba2_cache(cfg: ArchConfig, batch: int, device="cuda") -> dict:
    return attn.init_from_specs(mamba2_cache_specs(cfg, batch), device)


def recurrent_step(old, dA, dt, xh, Bv, Cv, D):
    """One token of the SSD recurrence on plain tensors: the state
    ``old [b, h, p, n]`` decayed by ``dA [b, h]`` plus the rank-1 input
    ``(dt·x) ⊗ B``, then ``y = state·C + D·x`` -> (state, y [b, h, p])."""
    state = old * dA[..., None, None] + (dt[..., None] * xh)[..., None] * Bv[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Cv) + D[None, :, None] * xh
    return state, y


def mamba2_decode(params, x: torch.Tensor, cfg: ArchConfig, cache: dict,
                  update_mask: torch.Tensor | None = None):
    """One-token recurrent update. x: [B, 1, D] -> (y [B, 1, D], cache), the
    cache written in place.

    ``update_mask`` ([B] bool, optional) gates the state write-back per row:
    rows where it is False keep their ssm/conv state bit for bit (their y is
    garbage the caller ignores).  This lets a grouped decode run over the
    whole batch without pad tokens advancing other slots' state.  ``None``
    updates every row.
    """
    B = x.shape[0]
    d_inner, H, _ = _dims(cfg)
    n, g, hd = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_head_dim
    f32 = torch.float32
    x = cm.shard(x, "batch", None, None)       # the batch's rows, whatever placed them before
    proj = cm.linear(params["in_proj"], x[:, 0], cfg.quant)     # [B, proj]
    part = _part(cfg, x)
    h0, h1 = part.h0, part.h1
    z, xh, Bm, Cm, dt_raw = _split_proj(cfg, part.local(proj))
    b, ci = xh.shape[0], (h1 - h0) * hd
    xBC_new = torch.cat([xh, Bm, Cm], dim=-1)                   # [b, conv_ch]
    conv_old = part.local(cache["conv_state"])                  # [b, w-1, conv_ch]
    window = torch.cat([conv_old.to(f32), xBC_new[:, None, :].to(f32)], dim=1)  # [b, w, ch]
    # the conv on the rank's heads' x channels and on B and C whole
    conv = torch.einsum("bwc,wc->bc", part.channels(window, cfg),
                        part.channels(part.whole(params["conv_w"]), cfg)) \
        + part.channels(part.whole(params["conv_b"]), cfg)
    xBC = F.silu(conv)
    xh = xBC[:, :ci].reshape(b, h1 - h0, hd)
    Bv = xBC[:, ci: ci + g * n].reshape(b, g, n).repeat_interleave(H // g, dim=1)[:, h0:h1]
    Cv = xBC[:, ci + g * n:].reshape(b, g, n).repeat_interleave(H // g, dim=1)[:, h0:h1]
    dt = F.softplus(dt_raw[:, h0:h1].to(f32) + part.whole(params["dt_bias"])[h0:h1])  # [b, h]
    A = -torch.exp(part.whole(params["A_log"])[h0:h1])
    dA = torch.exp(dt * A[None, :])                             # [b, h]
    old = part.local(cache["ssm_state"], heads_dim=1)           # [b, h, p, n]
    state, y = recurrent_step(old, dA, dt, xh, Bv, Cv, part.whole(params["D"])[h0:h1])
    y = part.back(y.reshape(b, ci).to(x.dtype), (B, d_inner), heads_dim=1)
    z = part.back(z[:, h0 * hd: h1 * hd], (B, d_inner), heads_dim=1)
    y = cm.rms_norm_gated(params["norm"], y, z, cfg.norm_eps)
    # whole on "model" before out_proj: one token has no sequence to split
    y = cm.shard(y, "batch", None)
    out = cm.linear(params["out_proj"], y, cfg.quant)[:, None, :]
    new_conv = window[:, 1:].to(conv_old.dtype)
    if update_mask is not None:
        keep = part.local(update_mask.to(torch.bool))
        state = torch.where(keep[:, None, None, None], state, old)
        new_conv = torch.where(keep[:, None, None], new_conv, conv_old)
    part.write(cache["ssm_state"], state, heads_dim=1)
    part.write(cache["conv_state"], new_conv)
    return out, cache
