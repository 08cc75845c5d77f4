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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import attention as attn


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


def _mamba2_seq(params, x: torch.Tensor, cfg: ArchConfig, *, want_cache: bool):
    """Shared full-sequence core of forward (train) and prefill (serve)."""
    B, L, _ = x.shape
    d_inner, H, _ = _dims(cfg)
    n, g = cfg.ssm_state, cfg.ssm_ngroups
    proj = cm.linear(params["in_proj"], x, cfg.quant)
    z, xh, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xBC_pre = torch.cat([xh, Bm, Cm], dim=-1)                    # pre-conv stream
    xBC = _causal_dconv(xBC_pre, params["conv_w"], params["conv_b"])
    xh = xBC[..., :d_inner].reshape(B, L, H, cfg.ssm_head_dim)
    Bm = xBC[..., d_inner: d_inner + g * n].reshape(B, L, g, n)
    Cm = xBC[..., d_inner + g * n:].reshape(B, L, g, n)
    # F.softplus returns v past 20, where fp32 rounds jax's logaddexp(v, 0) to v too
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    # the largest divisor of L that fits the configured chunk: any prompt
    # length works (a prime L degrades to chunk 1, still exact)
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:
        chunk -= 1
    y = ssd_chunked(xh, dt, A, Bm, Cm, params["D"], chunk, return_state=want_cache)
    cache = None
    if want_cache:
        y, final_state = y
        # conv_state holds the last (width-1) *pre-activation* xBC rows, what
        # token-wise decode keeps (zero-padded when L < width-1)
        w1 = cfg.ssm_conv_width - 1
        conv_state = F.pad(xBC_pre, (0, 0, w1, 0))[:, L:]
        cache = {"ssm_state": final_state, "conv_state": conv_state.to(cfg.torch_dtype)}
    y = y.reshape(B, L, d_inner)
    y = cm.rms_norm_gated(params["norm"], y.to(x.dtype), z, cfg.norm_eps)
    return cm.linear(params["out_proj"], y, cfg.quant), cache


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
    n, g = cfg.ssm_state, cfg.ssm_ngroups
    f32 = torch.float32
    proj = cm.linear(params["in_proj"], x[:, 0], cfg.quant)     # [B, proj]
    z, xh, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xBC_new = torch.cat([xh, Bm, Cm], dim=-1)                   # [B, conv_ch]
    window = torch.cat([cache["conv_state"].to(f32), xBC_new[:, None, :].to(f32)],
                       dim=1)                                   # [B, w, ch]
    conv = torch.einsum("bwc,wc->bc", window, params["conv_w"]) + params["conv_b"]
    xBC = F.silu(conv)
    xh = xBC[:, :d_inner].reshape(B, H, cfg.ssm_head_dim)
    rep = H // g
    Bv = xBC[:, d_inner: d_inner + g * n].reshape(B, g, n).repeat_interleave(rep, dim=1)
    Cv = xBC[:, d_inner + g * n:].reshape(B, g, n).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])          # [B, H]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                             # [B, H]
    old = cache["ssm_state"]
    state = old * dA[..., None, None] + (dt[..., None] * xh)[..., None] * Bv[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Cv) + params["D"][None, :, None] * xh
    y = cm.rms_norm_gated(params["norm"], y.reshape(B, d_inner).to(x.dtype), z, cfg.norm_eps)
    # on the batch's rows (a state placed otherwise makes y whole on them)
    y = cm.shard(y, "batch", None)
    out = cm.linear(params["out_proj"], y, cfg.quant)[:, None, :]
    new_conv = window[:, 1:].to(cache["conv_state"].dtype)
    if update_mask is not None:
        keep = update_mask.to(torch.bool)
        state = torch.where(keep[:, None, None, None], state, old)
        new_conv = torch.where(keep[:, None, None], new_conv, cache["conv_state"])
    old.copy_(state)
    cache["conv_state"].copy_(new_conv)
    return out, cache
