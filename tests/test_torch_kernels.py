"""Port parity: the plain PyTorch versions of the three kernels against the
JAX oracles in ``repro.kernels.ref`` (and the matmul against the Pallas
kernel in interpret mode), on the same numpy inputs, across the edge cases
the CUDA kernels mask: K and C not multiples of 8, tiny N/D, odd group
sizes, m_active < M, relu=False, pool 1 and > 1, stride 2 and asymmetric
SAME padding.

Tolerance rtol 1e-5, atol 1e-4: the reference's own (tests/test_kernels.py);
both sides accumulate in fp32 in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbz
from repro.kernels import binary_dwconv as jbdw
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import binarize as tbz
from repro_torch.core.binconv import conv_geometry, pad_nhwc
from repro_torch.kernels import binary_conv as tbck
from repro_torch.kernels import binary_dwconv as tbdw
from repro_torch.kernels import binary_matmul as tbmk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.cnn import MOBILENET_BLOCKS

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1, 1).astype(np.int8)


def _alpha(rng, shape):
    return (rng.random(shape) * 0.5 + 0.1).astype(np.float32)


def _flat_packed(B):
    """±1 [M, K, N] -> the reference's flat [M, ceil(K/8), N] (+1 row padding)."""
    pad = (-B.shape[1]) % 8
    if pad:
        B = np.concatenate([B, np.ones((B.shape[0], pad, B.shape[2]), np.int8)], axis=1)
    return np.array(jbz.pack_bits(jnp.asarray(B)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


MATMUL_CASES = [
    # T, K, N, M, group_size, m_active
    (5, 13, 7, 2, None, None),        # K % 8 != 0, tiny N
    (4, 1350, 43, 2, 675, 1),         # fc1-like K, group 675 (not a multiple of 8)
    (16, 24, 40, 3, 12, 2),           # grouped alpha crossing bytes
    (3, 64, 5, 2, 16, None),
    (16, 1024, 10, 2, None, None),    # head-like K
]


@pytest.mark.parametrize("T,K,N,M,group_size,m_active", MATMUL_CASES)
def test_binary_matmul_plain_matches_oracle_and_pallas(T, K, N, M, group_size, m_active):
    rng = np.random.default_rng(T * K + N)
    gs = group_size or K
    x = rng.standard_normal((T, K)).astype(np.float32)
    B = _signs(rng, (M, K, N))
    alpha = _alpha(rng, (M, K // gs, N))
    packed = _flat_packed(B)
    got = tref.binary_matmul_ref(torch.from_numpy(x), torch.from_numpy(packed),
                                 torch.from_numpy(alpha), K=K, group_size=gs,
                                 m_active=m_active)
    _close(got, jref.binary_matmul_ref(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(alpha),
                                       K=K, group_size=gs, m_active=m_active))
    _close(got, jops.binary_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(alpha),
                                   K=K, group_size=gs, m_active=m_active, interpret=True))


CONV_CASES = [
    # B, H, W, C, D, kh, kw, stride, padding, pool, M, m_active, relu, group_size
    (2, 12, 12, 3, 5, 7, 7, 1, "VALID", 2, 2, None, True, None),   # conv1-like
    (3, 9, 9, 5, 10, 4, 4, 1, "VALID", 3, 2, 1, True, None),       # conv2-like, C=5
    (2, 9, 9, 3, 8, 3, 3, 2, "SAME", 1, 2, None, True, None),      # stem-like
    (1, 6, 6, 12, 9, 1, 1, 1, "VALID", 1, 2, None, False, 6),      # pw, relu off
    (2, 8, 8, 5, 6, 4, 4, 1, "SAME", 2, 3, 2, True, 20),           # even SAME, groups span taps
    (2, 7, 7, 32, 16, 1, 1, 1, "VALID", 1, 2, 1, True, None),      # pw 7x7 map
]


@pytest.mark.parametrize(
    "B,H,W,C,D,kh,kw,stride,padding,pool,M,m_active,relu,group_size", CONV_CASES)
def test_binary_conv_plain_matches_oracle(B, H, W, C, D, kh, kw, stride, padding, pool,
                                          M, m_active, relu, group_size):
    rng = np.random.default_rng(B * H * C + D)
    K = kh * kw * C
    gs = group_size or K
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    Bpm = _signs(rng, (M, K, D))
    alpha = _alpha(rng, (M, K // gs, D))
    bias = rng.standard_normal(D).astype(np.float32)
    tap = tbck.pack_taps(torch.from_numpy(Bpm), kh, kw, C)
    got = tref.fused_binary_conv_relu_pool_ref(
        torch.from_numpy(x), tap, torch.from_numpy(alpha), kh=kh, kw=kw, stride=stride,
        padding=padding, pool=pool, m_active=m_active, bias=torch.from_numpy(bias),
        relu=relu)
    want = jref.fused_binary_conv_relu_pool_ref(
        jnp.asarray(x), jnp.asarray(_flat_packed(Bpm)), jnp.asarray(alpha), kh=kh, kw=kw,
        stride=stride, padding=padding, pool=pool, m_active=m_active,
        bias=jnp.asarray(bias), relu=relu)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


DW_CASES = [
    # B, H, W, C, stride, M, m_active, relu
    (2, 9, 9, 12, 1, 2, None, True),
    (3, 10, 10, 12, 2, 2, 1, False),
    (1, 7, 7, 32, 2, 3, 2, True),
    (2, 8, 8, 5, 1, 1, None, True),
]


@pytest.mark.parametrize("B,H,W,C,stride,M,m_active,relu", DW_CASES)
def test_binary_dwconv_plain_matches_oracle(B, H, W, C, stride, M, m_active, relu):
    rng = np.random.default_rng(B * H + C)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    Bpm = _signs(rng, (M, 9, C))
    alpha = _alpha(rng, (M, C))
    bias = rng.standard_normal(C).astype(np.float32)
    got = tref.binary_dwconv_relu_ref(
        torch.from_numpy(x), tbdw.pack_dw_taps(torch.from_numpy(Bpm)),
        torch.from_numpy(alpha), kh=3, kw=3, stride=stride, m_active=m_active,
        bias=torch.from_numpy(bias), relu=relu)
    want = jref.binary_dwconv_relu_ref(
        jnp.asarray(x), jbdw.pack_dw_taps(jnp.asarray(Bpm)), jnp.asarray(alpha),
        kh=3, kw=3, stride=stride, m_active=m_active, bias=jnp.asarray(bias), relu=relu)
    _close(got, want)


def test_ops_route_cpu_tensors_to_plain_versions_without_launching():
    """On a CPU tensor the wrappers are the plain versions (same numbers),
    launch no kernel and pick no plan; m_active above M is clamped."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 5)).astype(np.float32))
    Bpm = torch.from_numpy(_signs(rng, (2, 4 * 4 * 5, 6)))
    tap = tbck.pack_taps(Bpm, 4, 4, 5)
    alpha = torch.from_numpy(_alpha(rng, (2, 1, 6)))
    bias = torch.zeros(6)
    tops.reset_launch_counts()
    picks = tops.plan_pick_count()
    got = tops.binary_conv2d(x, tap, alpha, bias, kh=4, kw=4, padding="SAME", pool=3,
                             m_active=5)
    want = tref.fused_binary_conv_relu_pool_ref(x, tap, alpha, kh=4, kw=4, padding="SAME",
                                                pool=3, bias=bias)
    assert torch.equal(got, want)
    y = tops.binary_matmul(x.reshape(2, -1), tbz.pack_bits(torch.ones(1, 408, 3, dtype=torch.int8)),
                           torch.ones(1, 1, 3), K=405, group_size=405)
    torch.testing.assert_close(y, x.reshape(2, -1).sum(-1, keepdim=True).expand(2, 3),
                               rtol=RTOL, atol=ATOL)
    assert tops.launch_counts() == {"binary_conv": 0, "binary_dwconv": 0, "binary_matmul": 0}
    assert tops.plan_pick_count() == picks
    with pytest.raises(ValueError, match="unsupported device"):
        tops.binary_matmul(x.reshape(2, -1).to("meta"), tbz.pack_bits(
            torch.ones(1, 408, 3, dtype=torch.int8)), torch.ones(1, 1, 3), K=405,
            group_size=405)


@pytest.mark.parametrize("P", [1, 7, 49 * 16, 3 * 3 * 64, 112 * 112 * 16, 10 ** 7])
@pytest.mark.parametrize("D", [5, 32, 43, 150, 1000, 1024])
def test_picked_plans_are_launchable(P, D):
    """Every pick satisfies the launchers' plan checks (thread count, tile
    multiples, shared memory), so a compiled program never carries a plan
    the kernel would refuse."""
    tbck.check_plan(tops.pick_conv_plan(P, D))
    tbdw.check_plan(tops.pick_dwconv_plan(D))
    tbmk.check_plan(tops.pick_matmul_plan(P, D))
    with pytest.raises(ValueError, match="plan"):
        tbdw.check_plan((3, 64))
    with pytest.raises(ValueError, match="plan"):
        tbmk.check_plan((4, 128))


def _split_k_sum(x, B, alpha, gs, m_active):
    """The CUDA matmul's order of work, in float64: per chunk of
    ``k_chunks(K)``, a sum over its k in order of x times the folded weight
    ``w[k] = sum_m alpha[m, g(k)] * B[m, k]``, with g(k) kept by the kernel's
    countdown to the next group end; the chunks' sums added in chunk order."""
    T, K = x.shape
    y = np.zeros((T, B.shape[2]))
    for k0, k1 in tbmk.k_chunks(K):
        s = np.zeros_like(y)
        g = k0 // gs
        rem = gs - (k0 - g * gs)
        for k in range(k0, k1):
            assert g == k // gs
            w = sum(alpha[m, g] * B[m, k] for m in range(m_active))
            s += x[:, k:k + 1] * w
            rem -= 1
            if rem == 0:
                g, rem = g + 1, gs
        y += s
    return y


@pytest.mark.parametrize("K,group_size", [(13, None), (24, 12), (1350, 675), (64, 16),
                                          (1024, None), (340, None), (7, None)])
def test_split_k_chunks_tile_k_and_sum_like_the_plain_version(K, group_size):
    """The matmul kernel's K split: KSPLIT byte-aligned chunks that tile
    [0, K) in order (empty ones where K has fewer bytes than chunks), and a
    chunked sum over alpha-folded weights, with groups that cross bytes and
    chunk bounds, agrees with the plain version."""
    chunks = tbmk.k_chunks(K)
    assert len(chunks) == tbmk.KSPLIT
    assert chunks[0][0] == 0 and chunks[-1][1] == K
    for (a0, a1), (b0, b1) in zip(chunks, chunks[1:]):
        assert a1 == b0 or (a1 == K and b0 >= K)
    assert all(k0 % 8 == 0 and k0 <= max(k1, k0) for k0, k1 in chunks)
    assert sum(max(0, k1 - k0) for k0, k1 in chunks) == K
    rng = np.random.default_rng(K)
    gs = group_size or K
    T, N, M = 3, 5, 2
    x = rng.standard_normal((T, K)).astype(np.float32)
    B = _signs(rng, (M, K, N))
    alpha = _alpha(rng, (M, K // gs, N))
    want = tref.binary_matmul_ref(torch.from_numpy(x), tbz.pack_bits(
        tbz.pad_rows_to_byte(torch.from_numpy(B))), torch.from_numpy(alpha), K=K,
        group_size=gs)
    np.testing.assert_allclose(_split_k_sum(x.astype(np.float64), B, alpha, gs, M),
                               want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("H,W,stride", [
    (7, 7, 2),      # odd map at stride 2: pads (1, 1)
    (14, 14, 2),    # even map at stride 2: pads (0, 1)
    (9, 9, 1), (8, 8, 1), (10, 10, 2), (15, 14, 2), (14, 15, 1),
    (1, 1, 1), (1, 1, 2),   # 1x1 maps
])
def test_dwconv_geometry_matches_pad_nhwc(H, W, stride):
    """The depth-wise kernel takes the unpadded input, the low-side pads and
    the output size from ``conv_geometry``; its border taps read zero.  Those
    must be what ``pad_nhwc`` pads and what the plain version outputs, and
    the kernel's strip walk must visit each output's taps in (i, j) order at
    the padded input's positions."""
    rng = np.random.default_rng(H * W + stride)
    x = torch.from_numpy(rng.standard_normal((2, H, W, 3)).astype(np.float32))
    (pt, pl), (U, V) = conv_geometry(H, W, 3, 3, stride, "SAME")
    xp = pad_nhwc(x, 3, 3, stride, "SAME")
    framed = torch.zeros_like(xp)
    framed[:, pt:pt + H, pl:pl + W] = x
    assert torch.equal(xp, framed)
    tap = tbdw.pack_dw_taps(torch.from_numpy(_signs(rng, (2, 9, 3))))
    alpha = torch.from_numpy(_alpha(rng, (2, 3)))
    plain = tref.binary_dwconv_relu_ref(x, tap, alpha, kh=3, kw=3, stride=stride)
    assert tuple(plain.shape) == (2, U, V, 3)
    assert 0 <= pt < 3 and 0 <= pl < 3
    assert (U - 1) * stride - pt < H and (V - 1) * stride - pl < W
    for ut, vt in ((1, 1), (1, 2), (2, 2), (2, 4)):   # every tile the plans allow
        nrow, ncol = (ut - 1) * stride + 3, (vt - 1) * stride + 3
        for u0 in range(0, U, ut):
            for v0 in range(0, V, vt):
                seen = {(q, o): [] for q in range(ut) for o in range(vt)
                        if u0 + q < U and v0 + o < V}
                for ir in range(nrow):
                    hi = u0 * stride - pt + ir
                    for col in range(ncol):
                        wi = v0 * stride - pl + col
                        for q, o in seen:
                            i, j = ir - q * stride, col - o * stride
                            if 0 <= i < 3 and 0 <= j < 3:
                                inside = 0 <= hi < H and 0 <= wi < W
                                seen[q, o].append((i, j))
                                want = xp[:, (u0 + q) * stride + i, (v0 + o) * stride + j]
                                got = x[:, hi, wi] if inside else torch.zeros(2, 3)
                                assert torch.equal(got, want)
                for taps in seen.values():
                    assert taps == [(i, j) for i in range(3) for j in range(3)]
    assert conv_geometry(H + 2, W + 2, 3, 3, 1, "VALID") == ((0, 0), (H, W))


@pytest.mark.parametrize("batch", [16, 3, 1])
def test_picked_plans_are_launchable_at_program_shapes(batch):
    """At every depth-wise and linear instruction shape of MobileNetV1-224
    and CNN-A (compiled batch, a ragged one and 1) the picks are launchable,
    and a matmul thread only gets more rows where the card still gets a
    block for every two SMs."""
    for C in [32] + [cout for _, cout in MOBILENET_BLOCKS[:-1]]:   # dw0..dw12
        tile, cols = tops.pick_dwconv_plan(C)
        tbdw.check_plan((tile, cols))
        assert cols >= min(C, 128)
    for T, N in [(4 * batch, 340), (4 * batch, 490), (4 * batch, 43), (batch, 1000)]:
        rows, cols = tops.pick_matmul_plan(T, N)
        tbmk.check_plan((rows, cols))
        assert rows == 1 or -(-T // rows) * -(-N // cols) >= 66
