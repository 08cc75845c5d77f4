"""Multi-level binary weight approximation (BinArray, §II) in PyTorch.

Port of ``repro/core/binarize.py``: Algorithm 1 (greedy residual
binarization + one least-squares solve for alpha), Algorithm 2 (alternate
B-refinement and the LS solve until B is stable or ``K_iters``), group-wise
alpha along the reduction axis, and LSB-first bit packing.

Conventions are the reference's: ``W[K, N]`` (reduction dim first),
``B[M, K, N]`` int8 in {-1, +1}, ``alpha[M, G, N]`` float32 with
``G = K // group_size``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BinApprox(NamedTuple):
    """Multi-level binary approximation of a weight matrix W[K, N]."""

    B: torch.Tensor       # [M, K, N] int8, values in {-1, +1}
    alpha: torch.Tensor   # [M, G, N] float32
    group_size: int


def _expand_groups(a: torch.Tensor, group_size: int, dim: int) -> torch.Tensor:
    """Repeat each group entry ``group_size`` times along ``dim``."""
    return torch.repeat_interleave(a, group_size, dim=dim)


def reconstruct(approx: BinApprox) -> torch.Tensor:
    """W_hat = sum_m alpha_m * B_m (paper Eq. 1), float32 [K, N]."""
    a = _expand_groups(approx.alpha, approx.group_size, dim=1)
    return torch.sum(a * approx.B.to(torch.float32), dim=0)


def residual_error(W: torch.Tensor, approx: BinApprox) -> torch.Tensor:
    """||W - W_hat||^2 (paper Eq. 4 objective), scalar."""
    return torch.sum((W.to(torch.float32) - reconstruct(approx)) ** 2)


def solve_alpha(W: torch.Tensor, B: torch.Tensor, group_size: int) -> torch.Tensor:
    """Optimal alpha for given binary tensors (paper Eq. 5), per group and
    column: solves ``(B_g^T B_g) alpha = B_g^T w_g`` with the reference's
    1e-6·trace ridge for rank-deficient Gram matrices.  Returns [M, G, N]."""
    M, K, N = B.shape
    G = K // group_size
    Bf = B.to(torch.float32).reshape(M, G, group_size, N)
    Wf = W.to(torch.float32).reshape(G, group_size, N)
    gram = torch.einsum("mgkn,lgkn->gnml", Bf, Bf)
    rhs = torch.einsum("mgkn,gkn->gnm", Bf, Wf)
    eye = torch.eye(M, dtype=torch.float32, device=B.device)
    trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
    jitter = 1e-6 * torch.clamp(trace, min=1.0)
    gram = gram + eye * jitter[..., None, None]
    alpha = torch.linalg.solve(gram, rhs[..., None])[..., 0]  # [G, N, M]
    return alpha.permute(2, 0, 1).contiguous()


def _signs(dW: torch.Tensor) -> torch.Tensor:
    return torch.where(dW >= 0, 1.0, -1.0)


def _greedy_binarize(W: torch.Tensor, M: int, group_size: int) -> torch.Tensor:
    """Steps 1-5 of Algorithm 1: greedy residual binarization -> B[M, K, N]."""
    K, N = W.shape
    G = K // group_size
    dW = W.to(torch.float32)
    levels = []
    for _ in range(M):
        Bm = _signs(dW)
        a = torch.mean(torch.abs(dW).reshape(G, group_size, N), dim=1)  # [G, N]
        dW = dW - Bm * _expand_groups(a, group_size, dim=0)
        levels.append(Bm.to(torch.int8))
    return torch.stack(levels)


def _check_groups(K: int, group_size: int | None) -> int:
    group_size = K if group_size is None else group_size
    if K % group_size:
        raise ValueError(f"group_size {group_size} must divide K={K}")
    return group_size


def algorithm1(W: torch.Tensor, M: int, *, group_size: int | None = None) -> BinApprox:
    """Paper Algorithm 1: greedy B, then one LS solve for alpha (Eq. 5)."""
    group_size = _check_groups(W.shape[0], group_size)
    B = _greedy_binarize(W, M, group_size)
    return BinApprox(B=B, alpha=solve_alpha(W, B, group_size), group_size=group_size)


def algorithm2(W: torch.Tensor, M: int, *, K_iters: int = 100,
               group_size: int | None = None) -> BinApprox:
    """Paper Algorithm 2: starting from Algorithm 1, re-derive each B_m as the
    sign of the residual under the current optimal alpha, re-solve Eq. 5,
    and stop when B is unchanged or after ``K_iters`` refinements (the
    reference's while-loop, early exit included)."""
    group_size = _check_groups(W.shape[0], group_size)
    init = algorithm1(W, M, group_size=group_size)
    Wf = W.to(torch.float32)

    def refine_B(alpha: torch.Tensor) -> torch.Tensor:
        dW = Wf
        levels = []
        for am in alpha:                                   # [G, N] per level
            Bm = _signs(dW)
            dW = dW - Bm * _expand_groups(am, group_size, dim=0)
            levels.append(Bm.to(torch.int8))
        return torch.stack(levels)

    B, B_old, alpha = init.B, -init.B, init.alpha
    it = 0
    while it < K_iters and bool(torch.any(B != B_old)):
        B_new = refine_B(alpha)
        alpha = solve_alpha(W, B_new, group_size)
        B_old, B = B, B_new
        it += 1
    return BinApprox(B=B, alpha=alpha, group_size=group_size)


def approximate_tensor(W: torch.Tensor, M: int, *, algorithm: int = 2,
                       K_iters: int = 100, group_size: int | None = None,
                       reduce_axes: tuple[int, ...] | None = None,
                       ) -> tuple[BinApprox, tuple[int, ...]]:
    """Binarize an arbitrary-rank weight tensor: ``reduce_axes`` are
    flattened into K, the remaining axes into N.  Returns the approximation
    of the [K, N] matrix plus the permutation used."""
    if reduce_axes is None:
        reduce_axes = tuple(range(W.ndim - 1))
    out_axes = tuple(i for i in range(W.ndim) if i not in reduce_axes)
    perm = reduce_axes + out_axes
    K = 1
    for i in reduce_axes:
        K *= W.shape[i]
    Wm = W.permute(perm).reshape(K, -1)
    if algorithm == 2:
        return algorithm2(Wm, M, K_iters=K_iters, group_size=group_size), perm
    return algorithm1(Wm, M, group_size=group_size), perm


def pad_rows_to_byte(B: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Append +1 rows along ``dim`` up to a multiple of 8 (the padded rows
    multiply zero activations, or are sliced off after unpacking)."""
    pad = (-B.shape[dim]) % 8
    if not pad:
        return B
    shape = list(B.shape)
    shape[dim] = pad
    return torch.cat([B, torch.ones(shape, dtype=B.dtype, device=B.device)], dim=dim)


def pack_bits(B: torch.Tensor) -> torch.Tensor:
    """Pack ±1 int8 [M, K, N] -> uint8 [M, K//8, N]; bit j of byte k is
    B[8k+j] (LSB-first), +1 -> 1 and -1 -> 0.  K must be a multiple of 8."""
    M, K, N = B.shape
    if K % 8:
        raise ValueError(f"K={K} must be a multiple of 8 for packing")
    bits = (B > 0).to(torch.int32).reshape(M, K // 8, 8, N)
    shifts = torch.arange(8, dtype=torch.int32, device=B.device).reshape(1, 1, 8, 1)
    return torch.sum(bits << shifts, dim=2).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, K: int) -> torch.Tensor:
    """uint8 [M, K//8, N] -> ±1 int8 [M, K, N] (inverse of pack_bits)."""
    M, K8, N = packed.shape
    if K8 * 8 != K:
        raise ValueError(f"packed K//8={K8} inconsistent with K={K}")
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device).reshape(1, 1, 8, 1)
    bits = (packed.to(torch.int32)[:, :, None, :] >> shifts) & 1
    return (bits * 2 - 1).to(torch.int8).reshape(M, K, N)


# ---------------------------------------------------------------------------
# Compression factor (paper Eq. 6)
# ---------------------------------------------------------------------------

def compression_factor(N_c: int, M: int, *, bits_w: int = 32, bits_alpha: int = 8,
                       n_bias: int = 1) -> float:
    """(N_c + 1)·bits_w / (M·(N_c + bits_alpha)), paper Eq. 6 exactly."""
    return ((N_c + n_bias) * bits_w) / (M * (N_c + bits_alpha))


# ---------------------------------------------------------------------------
# Straight-through estimator (paper §V-B1 retraining)
# ---------------------------------------------------------------------------

class _STEBinarize(torch.autograd.Function):
    """Forward: the binary reconstruction ``W_hat`` itself; backward: the
    upstream gradient to ``W`` unchanged, none to ``W_hat``."""

    @staticmethod
    def forward(ctx, W, W_hat):
        return W_hat

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_binarize(W: torch.Tensor, W_hat: torch.Tensor) -> torch.Tensor:
    """BinaryNet's straight-through estimation ([5] in the paper), used for
    the paper's one-epoch retraining: the forward gives ``W_hat`` bit for bit
    (``W + (W_hat - W).detach()`` would round), and gradients reach the latent
    real-valued weights as if the binarization were the identity."""
    return _STEBinarize.apply(W, W_hat)


def fake_quant(W: torch.Tensor, M: int, *, algorithm: int = 2, K_iters: int = 8,
               group_size: int | None = None) -> torch.Tensor:
    """QAT forward: W [K, N] -> STE(binary reconstruction of W).  Algorithm 1
    or 2 runs on ``W.detach()`` under ``no_grad``, off the autograd tape (the
    JAX package's ``stop_gradient``); only the STE carries the gradient."""
    with torch.no_grad():
        Wd = W.detach()
        approx = (algorithm2(Wd, M, K_iters=K_iters, group_size=group_size)
                  if algorithm == 2 else algorithm1(Wd, M, group_size=group_size))
        W_hat = reconstruct(approx)
    return ste_binarize(W, W_hat)
