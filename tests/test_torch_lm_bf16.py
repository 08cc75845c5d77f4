"""The four dense LMs in their own dtype (bf16) with packed M=2 linears,
the port against the JAX package on the CPU.

Reduced gemma-2b, qwen3-14b (qk-norm), h2o-danube-1.8b (sliding window,
cut to 4 so a 6-token prompt wraps its ring) and codeqwen1.5-7b
(``qkv_bias``) in bfloat16 with ``QuantConfig(mode="binary", M=2,
K_iters=2)``.  Weights are drawn in bf16 and binarized by the JAX package
(packed bits uint8, alphas fp32, embeddings and norms bf16) and cross over
by ``params_from_numpy``, so both sides run the same bytes: on the CPU the
port's matmul route is its plain version, which widens the bf16 rows to
fp32 as the kernel does on the card.  Each side runs the teacher-forced
forward of 6 tokens at B = 2, a prefill of the same tokens (max_len 16)
and 2 decode steps.

Tolerance: logits and float cache leaves rtol 2e-2 / atol 2e-2·max|want|
(``test_torch_lm_encdec.py``'s bf16 bound, whose docstring gives the
reason: the two packages round bf16 activations at different points, and
a bf16 value carries 8 significant bits); integer cache leaves exact.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import binlinear as jbl
from repro.models import api as japi
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core import binlinear as tbl
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm

ARCHS = ("gemma_2b", "qwen3_14b", "h2o_danube_1_8b", "codeqwen15_7b")
JQC = jbl.QuantConfig(mode="binary", M=2, K_iters=2)
TQC = tbl.QuantConfig(mode="binary", M=2, K_iters=2)
BF16_REL = 2e-2
B, S, MAX_LEN, STEPS = 2, 6, 16, 2


def _cfgs(name):
    jc = jcb.reduced(jcb.get_config(name)).replace(dtype="bfloat16", quant=JQC)
    tc = tcb.reduced(tcb.get_config(name)).replace(dtype="bfloat16", quant=TQC)
    if jc.sliding_window:
        jc, tc = jc.replace(sliding_window=4), tc.replace(sliding_window=4)
    return jc, tc


def _leaves(tree):
    """Leaves in jax.tree.leaves' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _close(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.bfloat16 or want.dtype == np.float32, (got.dtype, want.dtype)
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=BF16_REL,
                               atol=BF16_REL * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def runs():
    """name -> [(step, port logits, jax logits, port cache, jax cache)]:
    the forward (no cache), the prefill, then each decode step."""
    out = {}
    rng = np.random.default_rng(0)
    for name in ARCHS:
        jc, tc = _cfgs(name)
        fp = japi.init_params(jc, jax.random.PRNGKey(0))
        packed = jax.jit(functools.partial(japi.binarize_model_params, jc))(fp)
        tp = params_from_numpy(jax.tree.map(np.asarray, packed), device="cpu")
        toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
        steps = rng.integers(0, jc.vocab, (STEPS, B, 1)).astype(np.int32)
        jf, _ = jax.jit(functools.partial(japi.forward, jc))(packed, {"tokens": toks})
        tf, _ = tapi.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
        rows = [("forward", tf, jf, None, None)]
        jl, jcache = jax.jit(functools.partial(japi.prefill, jc, max_len=MAX_LEN))(packed, toks)
        tl, tcache = tapi.prefill(tc, tp, torch.from_numpy(toks), max_len=MAX_LEN)
        rows.append(("prefill", tl, jl, tcm.tree_map(torch.clone, tcache), jcache))
        jstep = jax.jit(functools.partial(japi.decode_step, jc))
        for i in range(STEPS):
            pos = np.full((B,), S + i, np.int32)
            jl, jcache = jstep(packed, {"tokens": steps[i], "pos": pos, "cache": jcache})
            tl, tcache = tapi.decode_step(tc, tp, {"tokens": torch.from_numpy(steps[i]),
                                                   "pos": torch.from_numpy(pos),
                                                   "cache": tcache})
            rows.append((f"decode {i}", tl, jl, tcm.tree_map(torch.clone, tcache), jcache))
        out[name] = rows
    return out


@pytest.mark.parametrize("step", ["forward", "prefill", "decode 0", "decode 1"])
@pytest.mark.parametrize("name", ARCHS)
def test_bf16_packed_lm_matches_the_reference(runs, name, step):
    (got, want, gcache, wcache), = [r[1:] for r in runs[name] if r[0] == step]
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    _close(got, want)
    if gcache is not None:
        g, w = tcm.tree_leaves(gcache), _leaves(jax.tree.map(np.asarray, wcache))
        assert len(g) == len(w)
        for gl, wl in zip(g, w):
            _close(gl, wl)
