"""Port parity: binarization and packing in ``repro_torch`` against ``repro``.

The same numpy inputs go through the JAX function and its PyTorch
counterpart.  Packing is compared byte for byte.  Algorithm 2 is compared
by its residual ||W - W_hat||² within 1e-4 relative (the two frameworks sum
in another order, so B may differ at sign ties, and the objective is what
the algorithm promises); ``solve_alpha`` on the same B is allclose at
rtol 1e-5 / atol 1e-6 (one fp32 M×M solve per group and column).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbz
from repro.kernels import binary_conv as jbck
from repro.kernels import binary_dwconv as jbdw
from repro_torch.core import binarize as tbz
from repro_torch.core import binlinear as tbl
from repro_torch.kernels import binary_conv as tbck
from repro_torch.kernels import binary_dwconv as tbdw

jax.config.update("jax_platform_name", "cpu")


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1, 1).astype(np.int8)


@pytest.mark.parametrize("M,K,N", [(1, 8, 5), (2, 64, 43), (3, 1352, 7)])
def test_pack_bits_byte_identical(M, K, N):
    B = _signs(np.random.default_rng(K), (M, K, N))
    want = np.asarray(jbz.pack_bits(jnp.asarray(B)))
    got = tbz.pack_bits(torch.from_numpy(B)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbz.unpack_bits(torch.from_numpy(got), K).numpy(), B)


@pytest.mark.parametrize("kh,kw,C,D", [(7, 7, 3, 5), (4, 4, 5, 150), (1, 1, 32, 64),
                                       (3, 3, 3, 32)])
def test_pack_taps_byte_identical(kh, kw, C, D):
    B = _signs(np.random.default_rng(C * D), (2, kh * kw * C, D))
    want = np.asarray(jbck.pack_taps(jnp.asarray(B), kh, kw, C))
    got = tbck.pack_taps(torch.from_numpy(B), kh, kw, C).numpy()
    assert got.shape == (2, kh * kw, -(-C // 8), D)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbck.unpack_taps(torch.from_numpy(got), C).numpy(), B)


@pytest.mark.parametrize("C", [12, 32])
def test_pack_dw_taps_byte_identical(C):
    B = _signs(np.random.default_rng(C), (2, 9, C))
    want = np.asarray(jbdw.pack_dw_taps(jnp.asarray(B)))
    got = tbdw.pack_dw_taps(torch.from_numpy(B)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbdw.unpack_dw_taps(torch.from_numpy(got), C).numpy(),
        np.asarray(jbdw.unpack_dw_taps(jnp.asarray(want), C)))


@pytest.mark.parametrize("M,group_size", [(2, None), (3, 16), (2, 12)])
def test_solve_alpha_matches(M, group_size):
    rng = np.random.default_rng(M)
    K, N = 48, 10
    W = rng.standard_normal((K, N)).astype(np.float32)
    gs = group_size or K
    # the greedy levels of W: the well-conditioned B the algorithms solve for
    B = np.asarray(jbz.algorithm1(jnp.asarray(W), M, group_size=gs).B)
    want = np.asarray(jbz.solve_alpha(jnp.asarray(W), jnp.asarray(B), gs))
    got = tbz.solve_alpha(torch.from_numpy(W), torch.from_numpy(B), gs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M,group_size,algorithm", [(1, None, 2), (2, None, 2),
                                                    (3, 16, 2), (2, None, 1)])
def test_algorithm_residual_matches(M, group_size, algorithm):
    W = np.random.default_rng(7 + M).standard_normal((64, 24)).astype(np.float32)
    jfn, tfn = ((jbz.algorithm2, tbz.algorithm2) if algorithm == 2
                else (jbz.algorithm1, tbz.algorithm1))
    kw = {"K_iters": 10} if algorithm == 2 else {}
    ja = jfn(jnp.asarray(W), M, group_size=group_size, **kw)
    ta = tfn(torch.from_numpy(W), M, group_size=group_size, **kw)
    want = float(jbz.residual_error(jnp.asarray(W), ja))
    got = float(tbz.residual_error(torch.from_numpy(W), ta))
    assert abs(got - want) <= 1e-4 * want, (got, want)
    assert ta.B.dtype == torch.int8 and ta.alpha.shape == tuple(ja.alpha.shape)


def test_binarize_params_pads_k_with_plus_one_rows():
    W = torch.from_numpy(np.random.default_rng(0).standard_normal((13, 6)).astype(np.float32))
    out = tbl.binarize_params({"w": W, "b": torch.zeros(6)},
                              tbl.QuantConfig(mode="binary", M=2))
    assert tuple(out["B_packed"].shape) == (2, 2, 6) and "b" in out
    B = tbz.unpack_bits(out["B_packed"], 16)
    assert bool((B[:, 13:, :] == 1).all())
