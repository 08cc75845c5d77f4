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
from repro_torch.core.binconv import conv_geometry, im2col, pad_nhwc
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


@pytest.mark.parametrize("m_active", [1, 2])
def test_binary_matmul_returns_the_input_dtype(m_active):
    """A bf16 x comes back bf16, summed in fp32 on both sides: the port's
    wrapper against the JAX package's binary linear (ref path, which casts
    back to x's dtype).  Tolerance: bf16's own (rtol 1.6e-2, atol 1e-5),
    one rounding of the same fp32 sum to bf16 on each side."""
    from repro.core import binlinear as jbl

    rng = np.random.default_rng(7 + m_active)
    T, K, N = 6, 40, 24
    x = rng.standard_normal((2, T, K)).astype(np.float32)
    packed = _flat_packed(_signs(rng, (2, K, N)))
    alpha = _alpha(rng, (2, 1, N))
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    want = jbl.apply_linear({"B_packed": jnp.asarray(packed), "alpha": jnp.asarray(alpha)},
                            jx, jbl.QuantConfig(mode="binary", m_active=m_active))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tops.binary_matmul(tx, torch.from_numpy(packed), torch.from_numpy(alpha), K=K,
                             group_size=K, m_active=m_active)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == (2, T, N)
    torch.testing.assert_close(got.float(), torch.from_numpy(np.asarray(want, np.float32)),
                               rtol=1.6e-2, atol=1e-5)
    f32 = tops.binary_matmul(tx.float(), torch.from_numpy(packed), torch.from_numpy(alpha),
                             K=K, group_size=K, m_active=m_active)
    assert f32.dtype == torch.float32


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
    # a meta x (the dry run) gets the result's shape and dtype and runs nothing;
    # the conv wrappers have no meta route
    y = tops.binary_matmul(x.reshape(2, -1).to("meta", torch.bfloat16), tbz.pack_bits(
        torch.ones(1, 408, 3, dtype=torch.int8)), torch.ones(1, 1, 3), K=405, group_size=405)
    assert y.device.type == "meta" and y.shape == (2, 3) and y.dtype == torch.bfloat16
    assert tops.launch_counts() == {"binary_conv": 0, "binary_dwconv": 0, "binary_matmul": 0}
    assert tops.plan_pick_count() == picks
    with pytest.raises(ValueError, match="unsupported device"):
        tops.binary_conv2d(x.to("meta"), tap, alpha, bias, kh=4, kw=4, padding="SAME", pool=3)


@pytest.mark.parametrize("P", [1, 7, 49 * 16, 3 * 3 * 64, 112 * 112 * 16, 10 ** 7])
@pytest.mark.parametrize("D", [5, 32, 43, 150, 1000, 1024])
@pytest.mark.parametrize("pool", [1, 2, 6])
def test_picked_plans_are_launchable(P, D, pool):
    """Every pick satisfies the launchers' plan checks (thread count, tile
    sizes, whole pool windows per block, shared memory), so a compiled
    program never carries a plan the kernel would refuse."""
    tbck.check_plan(tops.pick_conv_plan(P * pool * pool, D, pool), pool)
    tbdw.check_plan(tops.pick_dwconv_plan(D))
    tbmk.check_plan(tops.pick_matmul_plan(P, D))
    with pytest.raises(ValueError, match="plan"):
        tbdw.check_plan((3, 64))
    with pytest.raises(ValueError, match="plan"):
        tbmk.check_plan((4, 128))
    with pytest.raises(ValueError, match="plan"):
        tbck.check_plan((64, 64), pool=9)


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
    """At every conv, depth-wise and linear instruction shape of
    MobileNetV1-224 and CNN-A (compiled batch, a ragged one and 1) the
    picks are launchable, a matmul thread only gets more rows where the
    card still gets a block for every two SMs, and the conv's 96-row tile
    is only picked where it keeps three quarters of the SMs busy."""
    for C in [32] + [cout for _, cout in MOBILENET_BLOCKS[:-1]]:   # dw0..dw12
        tile, cols = tops.pick_dwconv_plan(C)
        tbdw.check_plan((tile, cols))
        assert cols >= min(C, 128)
    for T, N in [(4 * batch, 340), (4 * batch, 490), (4 * batch, 43), (batch, 1000)]:
        rows, cols = tops.pick_matmul_plan(T, N)
        tbmk.check_plan((rows, cols))
        assert rows == 1 or -(-T // rows) * -(-N // cols) >= 66
    convs = [(batch * 42 * 42, 5, 2), (batch * 18 * 18, 150, 6),   # CNN-A conv1, conv2
             (batch * 112 * 112, 32, 1)]                          # the stem
    hw = 112
    for stride, cout in MOBILENET_BLOCKS:                         # pw0..pw12
        hw //= stride
        convs.append((batch * hw * hw, cout, 1))
    for P, D, pool in convs:
        plan = tops.pick_conv_plan(P, D, pool)
        tbck.check_plan(plan, pool)
        assert tbck.shared_bytes(plan) <= tbck.SHMEM_LIMIT
        assert plan[1] >= min(D, 64)
        assert plan != (96, 128) or tops.conv_blocks(P, D, pool, plan) >= 3 * 132 // 4


def _packed_row(k, C):
    t = k // C
    return t * -(-C // 8) + (k - t * C) // 8


def _kernel_folded_weights(tap, alpha, C, gs, m_active, cols):
    """The CUDA conv's fold, in float64, read from the packed bytes the way
    the kernel stages them: per chunk of ``K_CHUNK`` k, packed rows
    ``[row(k0), row(k_last)]`` of each level copied as aligned 4-byte words
    from column block ``d0``; each thread's slice of
    ``K_CHUNK * cols / THREADS`` k walks (tap, channel) and counts down to its group's end, and folds
    ``w = sum_m alpha[m, g(k), d] * (+-1)`` in level order.  Where C and the
    group size are multiples of 8 the kernel reads k's byte as row
    ``(k - k0) // 8``, bit ``k % 8``, which must be the same byte and bit."""
    M, T, C8, D = tap.shape
    K = T * C
    bytewise = C % 8 == 0 and gs % 8 == 0
    flat = tap.reshape(-1).numpy()
    al = alpha.numpy().astype(np.float64)
    w = np.zeros((K, D))
    kpt = tbck.K_CHUNK * cols // tbck.THREADS
    for k0 in range(0, K, tbck.K_CHUNK):
        kl = min(k0 + tbck.K_CHUNK, K) - 1
        row0 = _packed_row(k0, C)
        nr = _packed_row(kl, C) - row0 + 1
        assert 1 <= nr <= tbck.K_CHUNK
        for d0 in range(0, D, cols):
            for fd in range(min(cols, D - d0)):
                d = d0 + fd
                shift = [((m * T * C8 + row0) * (D & 3) + d0) & 3 for m in range(M)]
                for fk0 in range(0, tbck.K_CHUNK, kpt):
                    k = k0 + fk0
                    if k >= K:
                        continue
                    t, ch = divmod(k, C)
                    g, rem = k // gs, gs - (k - (k // gs) * gs)
                    for k in range(k, min(k0 + fk0 + kpt, K)):
                        assert (t, ch, g) == (k // C, k % C, k // gs)
                        rr = t * C8 + (ch >> 3) - row0
                        assert 0 <= rr < nr
                        if bytewise:
                            assert (rr, ch & 7) == ((k - k0) >> 3, k & 7)
                            assert k // gs == (k | 7) // gs    # no group ends mid-byte
                        for m in range(m_active):
                            start = (m * T * C8 + row0 + rr) * D + d0
                            s = (shift[m] + rr * (D & 3)) & 3
                            assert s == start & 3 and s + fd < 4 * (cols // 4 + 1)
                            byte = int(flat[(start & ~3) + s + fd])
                            sign = 1.0 if (byte >> (ch & 7)) & 1 else -1.0
                            w[k, d] += al[m, g, d] * sign
                        rem -= 1
                        if rem == 0:
                            g, rem = g + 1, gs
                        ch += 1
                        if ch == C:
                            ch, t = 0, t + 1
    return w


@pytest.mark.parametrize(
    "B,H,W,C,D,kh,kw,stride,padding,pool,M,m_active,relu,group_size,cols", [
        (2, 12, 12, 3, 5, 7, 7, 1, "VALID", 2, 2, None, True, None, 32),   # conv1-like
        (3, 9, 9, 5, 10, 4, 4, 1, "VALID", 3, 2, 1, True, None, 64),       # conv2-like, C=5
        (2, 9, 9, 3, 8, 3, 3, 2, "SAME", 1, 2, None, True, None, 32),      # stem, odd map
        (2, 8, 8, 5, 6, 4, 4, 1, "SAME", 2, 3, 2, True, 20, 128),          # groups span taps
        (1, 6, 6, 12, 9, 1, 1, 1, "VALID", 1, 2, None, False, 6, 32),      # C=12 ends mid-byte
        (2, 7, 7, 40, 43, 1, 1, 1, "VALID", 1, 3, 3, False, 20, 64),       # C=40, D=43
        (1, 5, 5, 64, 150, 1, 1, 1, "VALID", 1, 2, None, True, None, 128),  # D=150
        (2, 3, 3, 64, 37, 1, 1, 1, "VALID", 1, 2, None, True, 16, 32),     # groups of 16, D=37
    ])
def test_conv_kernel_fold_and_row_order_match_the_plain_version(
        B, H, W, C, D, kh, kw, stride, padding, pool, M, m_active, relu, group_size, cols):
    """The conv kernel's order of work, in float64: levels folded into one
    weight per (k, d) from the staged packed bytes, one sum over k per
    unpooled output row, bias, the max over each window's rows in the
    kernel's row order (``gemm_rows``), ReLU; against the plain version."""
    rng = np.random.default_rng(B * H * C + D + cols)
    K = kh * kw * C
    gs = group_size or K
    m = min(m_active or M, M)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    tap = tbck.pack_taps(torch.from_numpy(_signs(rng, (M, K, D))), kh, kw, C)
    alpha = torch.from_numpy(_alpha(rng, (M, K // gs, D)))
    bias = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    w = _kernel_folded_weights(tap, alpha, C, gs, m, cols)
    B_pm = tbck.unpack_taps(tap, C).numpy().astype(np.float64)
    np.testing.assert_allclose(
        w, np.einsum("mkd,mkd->kd", B_pm[:m],
                     np.repeat(alpha.numpy().astype(np.float64), gs, axis=1)[:m]),
        rtol=1e-12)
    patches = im2col(x, kh, kw, stride, padding).numpy().astype(np.float64)
    conv = patches @ w + bias.numpy()          # [B, U, V, D]
    U, V = conv.shape[1:3]
    want = tref.fused_binary_conv_relu_pool_ref(
        x, tap, alpha, kh=kh, kw=kw, stride=stride, padding=padding, pool=pool,
        m_active=m_active, bias=bias, relu=relu).numpy()
    for rows in tbck.ROWS:
        idx = tbck.gemm_rows(B, U // pool, V // pool, pool, rows).numpy()
        nwin = rows // pool ** 2
        got = np.zeros(want.shape)
        for blk in range(idx.shape[0]):
            for wq in range(nwin):
                q = blk * nwin + wq
                if q >= B * (U // pool) * (V // pool):
                    continue
                b, u, v = idx[blk, wq * pool ** 2:(wq + 1) * pool ** 2].T
                best = conv[b, u, v].max(axis=0)
                got.reshape(-1, D)[q] = np.maximum(best, 0) if relu else best
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,Uo,Vo,pool", [(3, 21, 21, 2), (5, 3, 3, 6), (2, 7, 5, 1),
                                          (1, 1, 1, 8), (4, 2, 3, 3)])
def test_gemm_rows_hold_whole_pool_windows(B, Uo, Vo, pool):
    """Every unpooled output lands in exactly one row, a block holds whole
    windows, and a max over each window's rows equals ``amax`` over the
    ``reshape(B, Uo, p, Vo, p, D)`` the plain version takes."""
    U, V, pp = Uo * pool, Vo * pool, pool * pool
    y = torch.from_numpy(np.random.default_rng(B + pool).standard_normal((B, U, V, 4)))
    want = y.reshape(B, Uo, pool, Vo, pool, 4).amax(dim=(2, 4)).reshape(-1, 4)
    for rows in tbck.ROWS:
        if pp > rows:
            continue
        idx = tbck.gemm_rows(B, Uo, Vo, pool, rows)
        used = idx[idx[..., 0] >= 0]
        assert used.shape[0] == B * U * V
        assert len({tuple(r) for r in used.tolist()}) == B * U * V
        nwin = rows // pp
        assert (idx[:, nwin * pp:] == -1).all()
        win = idx[:, :nwin * pp].reshape(-1, pp, 3)[:B * Uo * Vo]
        assert (win >= 0).all()
        got = y[win[..., 0], win[..., 1], win[..., 2]].amax(dim=1)
        assert torch.equal(got, want)
        b, u, v = win[..., 0], win[..., 1] // pool, win[..., 2] // pool
        assert ((b * Uo + u) * Vo + v == torch.arange(B * Uo * Vo)[:, None]).all()


@pytest.mark.parametrize("H,W,k,stride,padding,pool", [
    (7, 7, 3, 2, "SAME", 1),      # odd map at stride 2: pads (1, 1)
    (14, 14, 3, 2, "SAME", 1),    # even map at stride 2: pads (0, 1)
    (224, 224, 3, 2, "SAME", 1),  # the stem
    (15, 13, 3, 2, "SAME", 1),
    (8, 8, 4, 1, "SAME", 2),      # CNN-A's even 4x4
    (21, 21, 4, 1, "VALID", 6),   # conv2
    (48, 48, 7, 1, "VALID", 2),   # conv1
])
def test_conv_border_mask_reads_what_pad_nhwc_pads(H, W, k, stride, padding, pool):
    """The conv kernel reads the unpadded input: row r's field starts at
    ``(u*s - pt, v*s - pl)`` with the low-side pads of ``conv_geometry``, and
    a tap outside ``[0, H) x [0, W)`` reads zero.  That must be what the
    padded copy holds at ``(u*s + i, v*s + j)`` for every tap, and the
    output size must be the plain version's."""
    rng = np.random.default_rng(H * W + k)
    x = torch.from_numpy(rng.standard_normal((2, H, W, 2)).astype(np.float32))
    (pt, pl), (U, V) = conv_geometry(H, W, k, k, stride, padding)
    xp = pad_nhwc(x, k, k, stride, padding)
    assert (U, V) == ((xp.shape[1] - k) // stride + 1, (xp.shape[2] - k) // stride + 1)
    idx = tbck.gemm_rows(2, U // pool, V // pool, pool, 128).reshape(-1, 3)
    idx = idx[idx[:, 0] >= 0]
    b, u, v = idx.T
    for i in range(k):
        for j in range(k):
            h, w = u * stride - pt + i, v * stride - pl + j
            inside = (h >= 0) & (h < H) & (w >= 0) & (w < W)
            got = torch.where(inside[:, None], x[b, h.clamp(0, H - 1), w.clamp(0, W - 1)],
                              torch.zeros(()))
            assert torch.equal(got, xp[b, u * stride + i, v * stride + j])


# --- the direct path (C < 8) -------------------------------------------------

PROGRAM_SHAPES = [("cnn_a", (1, 48, 48, 3), 1.0), ("cnn_a", (64, 48, 48, 3), 1.0),
                  ("cnn_a", (1024, 48, 48, 3), 1.0), ("mobilenet", (16, 224, 224, 3), 1.0),
                  ("mobilenet", (128, 224, 224, 3), 1.0), ("mobilenet", (16, 128, 128, 3), 0.5),
                  ("mobilenet", (128, 128, 128, 3), 0.5)]


@pytest.mark.parametrize("arch,shape,width", PROGRAM_SHAPES)
def test_direct_path_takes_exactly_the_layers_under_a_byte_of_channels(arch, shape, width):
    """At every conv shape of CNN-A (batch 1, 64, 1024) and MobileNetV1
    (1.0/224 and 0.5/128 at 16 and 128) the launcher's rule gives a direct
    tile to each C < 8 layer (conv1, conv2, the stem) and to no other; the
    tile covers the output, fits shared memory and launches whole warps,
    and the verifier counts its bytes, not the frozen plan's."""
    from repro_torch import deploy
    from repro_torch.analysis import verify_program
    from repro_torch.core.binlinear import QuantConfig
    from repro_torch.deploy.program import ConvInstr

    program = deploy.abstract_program(arch, QuantConfig(mode="binary", M=2), shape,
                                      width_mult=width, device="cpu")
    taken = []
    for instr in program.instrs:
        if not isinstance(instr, ConvInstr):
            continue
        B, H, W, C = instr.stats.in_shape
        D = instr.B_tap_packed.shape[-1]
        _, (U, V) = conv_geometry(H, W, instr.kh, instr.kw, instr.stride, instr.padding)
        p = tbck.direct_plan(B, H, W, C, D, instr.kh, instr.kw, instr.stride, instr.pool,
                             (U, V))
        assert (p is not None) == (C < 8), (instr.name, C)
        if p is None:
            continue
        taken.append(instr.name)
        K = instr.kh * instr.kw * C
        assert p.shared_bytes == tbck.direct_shared_bytes(p, K) <= tbck.SHMEM_LIMIT
        assert p.threads % 32 == 0 and 32 <= p.threads <= tbck.DIRECT_THREADS
        assert p.nt * p.nw >= V // instr.pool and p.nbands * p.bu >= p.item_rows
        assert (p.nds - 1) * p.ndg * p.td < D <= p.nds * p.ndg * p.td
        assert p.blocks * p.nds >= min(132, B * p.item_rows)     # every SM a block
    assert taken == (["conv1", "conv2"] if arch == "cnn_a" else ["stem"])
    assert not [f for f in verify_program(program) if f.rule == "shared-memory"]


def test_direct_launch_count_is_reset_with_the_others():
    tbck.direct_launches = 3
    tops.reset_launch_counts()
    assert tbck.direct_launches == 0


DIRECT_CASES = [
    # B, H, W, C, D, kh, kw, stride, padding, pool
    (2, 48, 48, 3, 5, 7, 7, 1, "VALID", 2),      # conv1
    (3, 21, 21, 5, 150, 4, 4, 1, "VALID", 6),    # conv2
    (1, 224, 224, 3, 32, 3, 3, 2, "SAME", 1),    # the stem: pads (0, 0)
    (2, 17, 15, 3, 43, 3, 3, 2, "SAME", 1),      # odd sizes: pads (1, 1)
    (2, 8, 8, 5, 6, 4, 4, 1, "SAME", 2),         # CNN-A's even 4x4 SAME
    (3, 11, 11, 7, 6, 5, 3, 2, "SAME", 3),       # C = 7, kh != kw
    (2, 13, 13, 1, 16, 2, 2, 1, "VALID", 4),     # one window in a thread's columns
    (5, 10, 10, 4, 9, 3, 3, 1, "SAME", 5),
]


def _staged(x, p, staged):
    """The block's staged input as the kernel fills it: ``p.ni`` images of
    ``p.sh`` x ``p.sw`` pixels from ``staged`` = (b0, h0, w0), zero outside x."""
    B, H, W, C = x.shape
    b0, h0, w0 = staged
    out = torch.zeros(p.ni, p.sh, p.sw, C, dtype=x.dtype)
    hs, ws = torch.arange(h0, h0 + p.sh), torch.arange(w0, w0 + p.sw)
    inside = ((hs >= 0) & (hs < H))[:, None] & ((ws >= 0) & (ws < W))[None, :]
    for im in range(min(p.ni, B - b0)):
        got = x[b0 + im, hs.clamp(0, H - 1)][:, ws.clamp(0, W - 1)]
        out[im] = torch.where(inside[..., None], got, torch.zeros(()))
    return out


@pytest.mark.parametrize("B,H,W,C,D,kh,kw,stride,padding,pool", DIRECT_CASES)
def test_direct_blocks_stage_every_field_and_the_border_pad_nhwc_pads(
        B, H, W, C, D, kh, kw, stride, padding, pool):
    """Each output channel is computed by exactly one thread item; the
    staged region of the item's block holds each of its outputs' receptive
    fields, at the rows and columns the kernel reads them from, and there
    it holds what ``pad_nhwc``'s padded copy holds (the SAME border zero)."""
    (pt, pl), (U, V) = conv_geometry(H, W, kh, kw, stride, padding)
    p = tbck.direct_plan(B, H, W, C, D, kh, kw, stride, pool, (U, V))
    assert p is not None
    x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(H * W + C))
    xp = pad_nhwc(x, kh, kw, stride, padding)
    seen = torch.zeros(B, U, V, D, dtype=torch.int32)
    ii, jj = torch.arange(kh), torch.arange(kw)
    for (b0, h0, w0), items in tbck.direct_blocks(p, B, U, V, D, stride, pool, (pt, pl)):
        stage = _staged(x, p, (b0, h0, w0))
        rows = (torch.arange(p.sh) + h0 + pt).clamp(0, xp.shape[1] - 1)
        cols = (torch.arange(p.sw) + w0 + pl).clamp(0, xp.shape[2] - 1)
        for b, us, vs, ds in items:
            seen[b, us[0]:us[-1] + 1, vs[0]:vs[-1] + 1, ds[0]:ds[-1] + 1] += 1
            if ds[0] % (p.ndg * p.td):
                continue                   # the fields do not depend on the channels
            im = b - b0
            for u in us:
                r = u * stride - pt - h0 + ii     # the staged rows the kernel reads
                assert r.min() >= 0 and r.max() < p.sh
                for v in vs:
                    c = v * stride - pl - w0 + jj
                    assert c.min() >= 0 and c.max() < p.sw
                    field = stage[im, r][:, c]
                    assert torch.equal(field, xp[b, u * stride:u * stride + kh,
                                                 v * stride:v * stride + kw])
                    assert torch.equal(stage[im, r][:, c], xp[b, rows[r]][:, cols[c]])
    assert (seen == 1).all()


def _direct_folded_weights(tap, alpha, C, gs, m_active):
    """The direct path's fold, in float64: byte (m, t, d) of the packed taps
    holds channel c of tap t in bit c; ``w[k, d] = sum_m alpha[m, k // gs,
    d] * (+-1)`` over k = t*C + c, levels in order."""
    M, T, C8, D = tap.shape
    assert C8 == 1
    flat = tap.reshape(-1).numpy()
    al = alpha.numpy().astype(np.float64)
    w = np.zeros((T * C, D))
    for m in range(m_active):
        for t in range(T):
            byte = flat[(m * T + t) * D:(m * T + t + 1) * D].astype(np.int64)
            for c in range(C):
                k = t * C + c
                w[k] += al[m, k // gs] * np.where((byte >> c) & 1, 1.0, -1.0)
    return w


@pytest.mark.parametrize("B,H,W,C,D,kh,kw,stride,padding,pool", DIRECT_CASES[:2] + [
    (2, 9, 9, 3, 8, 3, 3, 2, "SAME", 1), (2, 8, 8, 5, 6, 4, 4, 1, "SAME", 2),
    (3, 11, 11, 7, 6, 5, 3, 2, "SAME", 3), (2, 13, 13, 1, 16, 2, 2, 1, "VALID", 4),
    (5, 10, 10, 4, 9, 3, 3, 1, "SAME", 5)])
def test_direct_path_fold_and_tile_walk_match_the_plain_version(
        B, H, W, C, D, kh, kw, stride, padding, pool):
    """The direct kernel's order of work, in float64: the levels folded per
    (k, d) from the packed bytes, each item's sums over (i, j, c) read from
    its block's staged tile, bias, the max over rows then over each
    window's columns, ReLU, written to the item's pooled outputs; against
    the plain version (M = 3, m_active 2, groups that span taps)."""
    M, m = 3, 2
    K = kh * kw * C
    gs = next(g for g in (20, 10, 5, 1) if K % g == 0 and g <= K)
    rng = np.random.default_rng(B * H + C * D)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    tap = tbck.pack_taps(torch.from_numpy(_signs(rng, (M, K, D))), kh, kw, C)
    alpha = torch.from_numpy(_alpha(rng, (M, K // gs, D)))
    bias = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    w = _direct_folded_weights(tap, alpha, C, gs, m)
    B_pm = tbck.unpack_taps(tap, C).numpy().astype(np.float64)
    np.testing.assert_allclose(w, np.einsum(
        "mkd,mkd->kd", B_pm[:m], np.repeat(alpha.numpy().astype(np.float64), gs, axis=1)[:m]),
        rtol=1e-12)
    want = tref.fused_binary_conv_relu_pool_ref(
        x, tap, alpha, kh=kh, kw=kw, stride=stride, padding=padding, pool=pool, m_active=m,
        bias=bias, relu=True).numpy()
    (pt, pl), (U, V) = conv_geometry(H, W, kh, kw, stride, padding)
    p = tbck.direct_plan(B, H, W, C, D, kh, kw, stride, pool, (U, V))
    got = np.full(want.shape, np.nan)
    ii, jj = np.arange(kh), np.arange(kw)
    for (b0, h0, w0), items in tbck.direct_blocks(p, B, U, V, D, stride, pool, (pt, pl)):
        stage = _staged(x, p, (b0, h0, w0)).numpy().astype(np.float64)
        for b, us, vs, ds in items:
            r = np.array(us)[:, None] * stride - pt - h0 + ii          # [rows, kh]
            c = np.array(vs)[:, None] * stride - pl - w0 + jj          # [cols, kw]
            field = stage[b - b0][r[:, None, :, None], c[None, :, None, :]]
            conv = field.reshape(len(us), len(vs), K) @ w[:, ds] + bias.numpy()[ds]
            if pool == 1:                                              # two rows, no window
                got[b, us[0]:us[-1] + 1, vs[0]:vs[-1] + 1, ds[0]:ds[-1] + 1] = np.maximum(conv, 0)
                continue
            colmax = conv.max(axis=0)                                  # over the rows
            for q in range(len(vs) // pool):
                best = colmax[q * pool:(q + 1) * pool].max(axis=0)     # over the window
                got[b, us[0] // pool, vs[q * pool] // pool, ds] = np.maximum(best, 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [1, 2, 3, 4, 5, 6, 7, 11, 13])
def test_direct_ring_holds_each_outputs_pixel_at_every_tap(kw):
    """The stride-1 ring of ``csrc/binary_conv.cu`` ``conv_row_ring``: slots
    0 .. DIRECT_COLS - 1 start with pixels 0 .. DIRECT_COLS - 1; at tap j
    (run in steps of DIRECT_COLS) output p reads slot (p + j) % DIRECT_COLS,
    and after tap j pixel DIRECT_COLS + j goes into slot j % DIRECT_COLS.
    Output p must read pixel p + j, and no pixel past the staged row's
    DIRECT_COLS + kw - 1 is loaded."""
    n = tbck.DIRECT_COLS
    ring = list(range(n))
    loaded = set(ring)
    for j0 in range(0, kw, n):
        for jj in range(n):
            j = j0 + jj
            if j >= kw:
                break
            assert [ring[(p + jj) % n] for p in range(n)] == [p + j for p in range(n)]
            if j + 1 < kw:
                ring[jj] = n + j
                loaded.add(n + j)
    assert loaded == set(range(n + kw - 1))
