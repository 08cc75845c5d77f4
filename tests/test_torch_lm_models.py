"""The port's dense LM stack against the JAX package, on the CPU.

Reduced configs (``configs.base.reduced``, dtype float32) with
``QuantConfig(mode="binary", M=2, K_iters=2)``; danube's window is cut to 4
so a 6-token prompt wraps its rolling cache.  Weights are drawn and
binarized by the JAX package and cross over by ``params_from_numpy``, so
both sides run the same packed bytes.  Each JAX reference runs once per
module (module-scoped fixtures).

Tolerances: binarized bits byte-identical; alphas rtol 1e-5 / atol 1e-7
(both solve the same 2x2 least-squares systems in fp32); one linear rtol
1e-5 / atol 1e-4 (the reference's kernel tolerance); logits and cache
leaves rtol 1e-5 / atol 1e-5 (fp32 sums in another order, |logits| < 1);
integer cache leaves exact; a uniform schedule ``torch.equal`` to the int.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
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
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttf

ARCHS = ("gemma_2b", "qwen3_14b", "h2o_danube_1_8b")
JQC = jbl.QuantConfig(mode="binary", M=2, K_iters=2)
TQC = tbl.QuantConfig(mode="binary", M=2, K_iters=2)
RTOL, ATOL = 1e-5, 1e-5


def _cfgs(name):
    jc = jcb.reduced(jcb.get_config(name)).replace(dtype="float32", quant=JQC)
    tc = tcb.reduced(tcb.get_config(name)).replace(dtype="float32", quant=TQC)
    if jc.sliding_window:
        jc, tc = jc.replace(sliding_window=4), tc.replace(sliding_window=4)
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """Leaves in jax.tree.leaves' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def models():
    """name -> (jax cfg, port cfg, jax fp tree, jax packed tree, port packed tree)."""
    out = {}
    for name in ARCHS:
        jc, tc = _cfgs(name)
        fp = japi.init_params(jc, jax.random.PRNGKey(0))
        packed = jax.jit(functools.partial(japi.binarize_model_params, jc))(fp)
        out[name] = (jc, tc, fp, packed, params_from_numpy(_np(packed), device="cpu"))
    return out


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", tcb.ARCH_IDS)
def test_configs_match_the_reference(name):
    """Every field the port's ArchConfig holds has the reference's value,
    at full size and reduced; the defaults agree too."""
    names = [f.name for f in dataclasses.fields(tcb.ArchConfig) if f.name != "quant"]
    assert {"remat", "onehot_loss"} <= set(names)      # the training knobs
    jfields = {f.name: f for f in dataclasses.fields(jcb.ArchConfig)}
    for f in dataclasses.fields(tcb.ArchConfig):
        if f.name != "quant" and f.default is not dataclasses.MISSING:
            assert jfields[f.name].default == f.default, f.name

    def fields(c):
        return {n: getattr(c, n) for n in names}

    jc, tc = jcb.get_config(name), tcb.get_config(name)
    assert fields(tc) == fields(jc)
    assert fields(tcb.reduced(tc)) == fields(jcb.reduced(jc))
    if tc.n_heads:          # both packages divide by zero for attention-free mamba2
        assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tc.torch_dtype == torch.bfloat16 and tc.replace(dtype="float32").torch_dtype \
        == torch.float32
    assert tapi.count_params(tc) == japi.count_params(jc)


def test_get_config_refuses_what_is_not_ported():
    """Every JAX config is ported; a name that is none of them raises."""
    assert sorted(tcb.ARCH_IDS) == sorted(jcb.ARCH_IDS)
    with pytest.raises(ValueError, match="unknown config"):
        tcb.get_config("whisper_large")


@pytest.mark.parametrize("name", ARCHS)
def test_binarize_model_params_matches(models, name):
    """Given the same fp tree, the packed bits are byte-identical and the
    alphas allclose; the tree has the reference's structure."""
    jc, tc, fp, packed, _ = models[name]
    got = tapi.binarize_model_params(tc, params_from_numpy(_np(fp), device="cpu"))
    want = _np(packed)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(tcm.tree_map(lambda _: 0, got))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        t = got
        for k in path:
            t = t[k.key]
        if w.dtype == np.uint8:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=str(path))
        else:
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-7, err_msg=str(path))


@pytest.fixture(scope="module")
def one_linear(models):
    """gemma's layer-0 w_down (K = 128 -> N = 64), packed, and a [2, 3, K] input."""
    _, _, _, packed, tp = models["gemma_2b"]
    jlin = jax.tree.map(lambda t: t[0], packed["layers"]["ffn"]["w_down"])
    x = np.random.default_rng(0).standard_normal((2, 3, 128)).astype(np.float32)
    return jlin, tcm.tree_index(tp["layers"]["ffn"]["w_down"], 0), x


@pytest.mark.parametrize("m_active", [1, 2])
@pytest.mark.parametrize("route", ["pallas_interpret", "ref"])
def test_apply_linear_matches_the_reference(one_linear, route, m_active):
    """The port's binary linear (its plain version on the CPU) against JAX's
    Pallas matmul in interpret mode and against JAX's ref path."""
    jlin, tlin, x = one_linear
    jq = JQC.replace(m_active=m_active, use_pallas=route == "pallas_interpret",
                     interpret=True)
    want = jbl.apply_linear(jlin, jnp.asarray(x), jq)
    got = tbl.apply_linear(tlin, torch.from_numpy(x), TQC.replace(m_active=m_active))
    _close(got, want, atol=1e-4)


def test_apply_linear_dense_and_fake_quant():
    """fp trees in both modes against the reference: the output, and in
    fake_quant the straight-through gradients to w (the upstream gradient
    through x, unchanged by the binarization) and to x (through W_hat)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    want = jbl.apply_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tbl.apply_linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                           torch.from_numpy(x))
    _close(got, want)
    jq = jbl.QuantConfig(mode="fake_quant", M=2, K_iters=8)
    tq = tbl.QuantConfig(mode="fake_quant", M=2, K_iters=8)
    want, jgrads = jax.value_and_grad(
        lambda p, x: jnp.sum(jbl.apply_linear(p, x, jq) ** 2), argnums=(0, 1))(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    tp = {"w": torch.from_numpy(w).requires_grad_(), "b": torch.from_numpy(b).requires_grad_()}
    tx = torch.from_numpy(x).requires_grad_()
    y = tbl.apply_linear(tp, tx, tq)
    got = torch.sum(y ** 2)
    gw, gb, gx = torch.autograd.grad(got, (tp["w"], tp["b"], tx))
    _close(got.detach(), want)
    for g, jg in ((gw, jgrads[0]["w"]), (gb, jgrads[0]["b"]), (gx, jgrads[1])):
        _close(g, jg)
    assert torch.equal(gw, tx.detach().T @ (2 * y.detach()))   # the STE: dL/dW_hat


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches(models, name):
    jc, tc, _, packed, tp = models[name]
    toks = _tokens(2, 9)
    want, _ = jax.jit(functools.partial(japi.forward, jc))(packed, {"tokens": toks})
    got, aux = tapi.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert float(aux["load_balance_loss"]) == 0.0


def test_query_chunked_forward_matches(models):
    """``attn_chunk`` evaluates the scores chunk by chunk."""
    jc, tc, _, packed, tp = models["gemma_2b"]
    toks = _tokens(1, 8, seed=3)
    want, _ = jax.jit(functools.partial(japi.forward, jc.replace(attn_chunk=4)))(
        packed, {"tokens": toks})
    got, _ = tapi.forward(tc.replace(attn_chunk=4), tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    whole, _ = tapi.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, whole.numpy())


def _check_cache(got, want):
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


@pytest.fixture(scope="module")
def decoded(models):
    """Per arch: prefill of 6 tokens at B=2 (max_len 16), then 3 decode
    steps, on both sides; danube's window of 4 makes the ring wrap."""
    out = {}
    for name in ARCHS:
        jc, tc, _, packed, tp = models[name]
        toks = _tokens(2, 6, seed=1)
        steps = _tokens(3, 2, seed=2)
        jl, jcache = jax.jit(functools.partial(japi.prefill, jc, max_len=16))(packed, toks)
        tl, tcache = tapi.prefill(tc, tp, torch.from_numpy(toks), max_len=16)
        rows = [(tl, jl, tcm.tree_map(torch.clone, tcache), jcache)]   # decode writes in place
        jstep = jax.jit(functools.partial(japi.decode_step, jc))
        for i in range(3):
            pos = np.full((2,), 6 + i, np.int32)
            tok = steps[i][:, None]
            jl, jcache = jstep(packed, {"tokens": tok, "pos": pos, "cache": jcache})
            tl, tcache = tapi.decode_step(tc, tp, {"tokens": torch.from_numpy(tok),
                                                   "pos": torch.from_numpy(pos),
                                                   "cache": tcache})
            rows.append((tl, jl, tcm.tree_map(torch.clone, tcache), jcache))
        out[name] = rows
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches(decoded, name):
    got, want, gcache, wcache = decoded[name][0]
    assert tuple(got.shape) == (2, 6, 512)
    _close(got, want)
    _check_cache(gcache, wcache)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match(decoded, name):
    for got, want, gcache, wcache in decoded[name][1:]:
        assert tuple(got.shape) == (2, 1, 512)
        _close(got, want)
        _check_cache(gcache, wcache)


def test_sliding_window_ring_wraps(decoded):
    """Window 4: after 6 prefill tokens and 3 steps, slot_pos holds 5..8 at
    their ring slots pos % 4."""
    slot_pos = decoded["h2o_danube_1_8b"][-1][2]["layers"]["slot_pos"]
    assert slot_pos.shape == (2, 2, 4)
    np.testing.assert_array_equal(slot_pos[0, 0].numpy(), [8, 5, 6, 7])


def test_cache_specs_match(models):
    for name in ARCHS:
        jc, tc, *_ = models[name]
        want = jax.tree.leaves(japi.cache_specs(jc, 3, 10))
        got = _leaves(tapi.cache_specs(tc, 3, 10))
        assert [tuple(s.shape) for s in got] == [s.shape for s in want]
        assert [str(s.dtype).split(".")[-1] for s in got] == [str(s.dtype) for s in want]
        init = _leaves(tapi.init_cache(tc, 3, 10, device="cpu"))
        for t, w in zip(init, jax.tree.leaves(japi.init_cache(jc, 3, 10))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_schedules_uniform_equals_int_and_mixed_differs(models):
    """m_schedule (1, 1) is m_active=1 bit for bit; (1, 2) differs from both
    uniform counts and matches the JAX package's (1, 2)."""
    jc, tc, _, packed, tp = models["gemma_2b"]
    toks = torch.from_numpy(_tokens(1, 7, seed=4))

    def fwd(**q):
        return tapi.forward(tc.replace(quant=TQC.replace(**q)), tp, {"tokens": toks})[0]

    assert torch.equal(fwd(m_schedule=(1, 1)), fwd(m_active=1))
    assert torch.equal(fwd(m_schedule=(2, 2)), fwd(m_active=2))
    mixed = fwd(m_schedule=(1, 2))
    assert not torch.allclose(mixed, fwd(m_active=1))
    assert not torch.allclose(mixed, fwd(m_active=2))
    jmixed = jc.replace(quant=JQC.replace(m_schedule=(1, 2)))
    want, _ = jax.jit(functools.partial(japi.forward, jmixed))(packed,
                                                               {"tokens": toks.numpy()})
    _close(mixed, want)
    logits, _ = tapi.prefill(tc.replace(quant=TQC.replace(m_schedule=(1, 1))), tp, toks,
                             max_len=8)
    assert torch.equal(logits, tapi.prefill(tc.replace(quant=TQC.replace(m_active=1)), tp,
                                            toks, max_len=8)[0])


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_other_families_raise(family):
    """The family's reduced config initialises; the same config under a
    family name no package knows raises ``ValueError`` in every entry
    point, as the JAX package's dispatch does."""
    name = {"encdec": "whisper_medium", "vlm": "internvl2_2b"}[family]
    cfg = tcb.reduced(tcb.get_config(name)).replace(dtype="float32")
    assert cfg.family == family
    assert tapi.count_params(cfg) == sum(t.numel() for t in tcm.tree_leaves(
        tapi.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")))
    cfg = cfg.replace(family=family.upper())
    for call in (lambda: tapi.init_params(cfg, torch.Generator(), device="cpu"),
                 lambda: tapi.forward(cfg, {}, {"tokens": None}),
                 lambda: tapi.loss_fn(cfg, {}, {"tokens": None, "labels": torch.zeros(1)}),
                 lambda: tapi.cache_specs(cfg, 1, 8),
                 lambda: tapi.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: tapi.prefill(cfg, {}, None, max_len=8),
                 lambda: tapi.scatter_cache(cfg, {}, 0, {}),
                 lambda: tapi.count_params(cfg),
                 lambda: tapi.decode_step(cfg, {}, {"tokens": None, "pos": None,
                                                    "cache": None})):
        with pytest.raises(ValueError, match=family.upper()):
            call()


def test_init_params_shapes_match_the_reference():
    """The port's own init gives the reference's tree, shapes and dtypes."""
    jc, tc = _cfgs("qwen3_14b")
    tc = tc.replace(dtype="bfloat16")
    want = jax.eval_shape(lambda k: japi.init_params(jc.replace(dtype="bfloat16"), k),
                          jax.random.PRNGKey(0))
    got = tapi.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(tcm.tree_map(lambda _: 0, got))
    assert [tuple(t.shape) for t in _leaves(got)] == [s.shape for s in jax.tree.leaves(want)]
    assert all(t.dtype == torch.bfloat16 for t in _leaves(got))
    assert sum(t.numel() for t in _leaves(got)) == tapi.count_params(tc)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    _, tc = _cfgs("gemma_2b")
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tapi.init_params(tc, gen),
                 lambda: tapi.init_cache(tc, 1, 8),
                 lambda: ttf.init_lm(gen, tc),
                 lambda: ttf.init_layer(gen, tc),
                 lambda: ttf.init_lm_cache(tc, 1, 8),
                 lambda: tattn.init_attn(gen, tc),
                 lambda: tattn.init_attn_cache(tc, 1, 8),
                 lambda: tattn.init_from_specs(tattn.attn_cache_specs(tc, 1, 8)),
                 lambda: tffn.init_ffn(gen, tc),
                 lambda: tcm.init_linear(gen, 8, 8, torch.float32),
                 lambda: tcm.init_embedding(gen, 8, 8, torch.float32),
                 lambda: tcm.init_rmsnorm(8),
                 lambda: tbl.init_linear(gen, 8, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_lm_trees(dtype):
    """fp trees (bfloat16 too, bit for bit) and packed trees with stacked
    [L, ...] leaves cross over unchanged."""
    jc, _ = _cfgs("gemma_2b")
    fp = _np(japi.init_params(jc.replace(dtype=dtype), jax.random.PRNGKey(1)))
    got = params_from_numpy(fp, device="cpu")
    for path, w in jax.tree_util.tree_flatten_with_path(fp)[0]:
        t = got
        for k in path:
            t = t[k.key]
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    assert got["layers"]["attn"]["wq"]["w"].shape == (2, 64, 64)
