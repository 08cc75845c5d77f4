"""The port's SSM (Mamba2 / SSD) and hybrid (Zamba2) families against the JAX
package, on the CPU: the chunked SSD scan, the causal conv, the gated norm,
the Mamba2 block with its recurrent cache and ``update_mask``, the hybrid's
shared attention block, the LMs, the loss, schedules and ``Server``.

Reduced configs (``configs.base.reduced``: mamba2 4 layers, d_model 64,
state 16, head_dim 16, chunk 16; zamba2 4 layers with the shared block
after layers 1 and 3), dtype float32, ``QuantConfig(mode="binary", M=2,
K_iters=2)`` unless a test names another mode.  Weights are drawn (and
binarized) by the JAX package and cross over by ``params_from_numpy``;
inputs are numpy arrays from seeded generators.  Each JAX reference runs
once per module where several tests read it.

Tolerances: ``ssd_chunked`` against the float64 recurrence rtol 2e-4 /
atol 2e-4 and chunk sizes against each other rtol 1e-5 / atol 1e-5 (the
reference's own, ``tests/test_ssm.py``), against JAX's rtol 1e-5 /
atol 1e-5; logits and cache leaves rtol 1e-5 / atol 1e-5 (fp32 sums in
another order); losses and gradients rtol 1e-5 with a floor of 1e-5 x the
leaf's largest entry; ``Server`` tokens equal and last logits rtol 2e-5 /
atol 5e-5 (the JAX serving tests'); bulk against token-wise admission's
cache rows rtol 1e-5 / atol 1e-5; masked state rows, packed bits,
``count_params`` and bf16 crossings exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import binlinear as jbl
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import ssm as jssm
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core import binlinear as tbl
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import hybrid as thyb
from repro_torch.models import ssm as tssm

jax.config.update("jax_platform_name", "cpu")

JQC = jbl.QuantConfig(mode="binary", M=2, K_iters=2)
TQC = tbl.QuantConfig(mode="binary", M=2, K_iters=2)
RTOL, ATOL = 1e-5, 1e-5
ARCHS = ("mamba2_2_7b", "zamba2_7b")


def _cfgs(name, mode="binary"):
    jc = jcb.reduced(jcb.get_config(name)).replace(dtype="float32", quant=JQC.replace(mode=mode))
    tc = tcb.reduced(tcb.get_config(name)).replace(dtype="float32", quant=TQC.replace(mode=mode))
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol)


def _close_rel(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _check_cache(got, want):
    assert len(tcm.tree_leaves(got)) == len(jax.tree.leaves(want))
    for g, w in zip(tcm.tree_leaves(got), jax.tree.leaves(want)):
        _close(g, w)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """name -> (jax cfg, port cfg, jax fp tree, jax packed tree, port fp tree,
    port packed tree)."""
    out = {}
    for name in ARCHS:
        jc, tc = _cfgs(name)
        fp = japi.init_params(jc, jax.random.PRNGKey(0))
        packed = jax.jit(functools.partial(japi.binarize_model_params, jc))(fp)
        out[name] = (jc, tc, fp, packed, params_from_numpy(_np(fp), device="cpu"),
                     params_from_numpy(_np(packed), device="cpu"))
    return out


# ----------------------------------------------------------------------- SSD --

def ssd_sequential(xh, dt, A, Bm, Cm, D):
    """The float64 token-by-token recurrence (``tests/test_ssm.py``'s), and
    the state after the last token."""
    b, l, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[-1]
    xh, dt, Bm, Cm, A, D = (np.asarray(t, np.float64) for t in (xh, dt, Bm, Cm, A, D))
    Bh, Ch = np.repeat(Bm, h // g, axis=2), np.repeat(Cm, h // g, axis=2)
    state = np.zeros((b, h, p, n))
    ys = []
    for t in range(l):
        state = state * np.exp(dt[:, t] * A[None])[..., None, None] + np.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], xh[:, t], Bh[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", state, Ch[:, t]) + D[None, :, None] * xh[:, t])
    return np.stack(ys, 1), state


def _ssd_inputs(seed, b=2, l=32, h=6, p=4, g=2, n=8):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    return xh, dt, A, Bm, Cm, np.ones(h, np.float32)


_jax_ssd = jax.jit(jssm.ssd_chunked, static_argnums=6, static_argnames="return_state")


def _port_ssd(args, chunk, **kw):
    return tssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk, **kw)


@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches(chunk, groups):
    """Against JAX's ``ssd_chunked`` and the float64 recurrence, y and the
    final state, heads factored over 1, 2 or 3 groups."""
    args = _ssd_inputs(chunk + groups, g=groups)
    y, state = _port_ssd(args, chunk, return_state=True)
    jy, jstate = _jax_ssd(*args, chunk, return_state=True)
    _close(y, jy)
    _close(state, jstate)
    ry, rstate = ssd_sequential(*args)
    _close(y, ry, rtol=2e-4, atol=2e-4)
    _close(state, rstate, rtol=2e-4, atol=2e-4)


def test_ssd_chunk_size_invariance():
    args = _ssd_inputs(1)
    _close(_port_ssd(args, 8), _port_ssd(args, 16).numpy())
    with pytest.raises(ValueError, match="multiple of the chunk"):
        _port_ssd(args, 5)


def test_ssd_gradients_are_finite_past_the_diagonal():
    """Large decays make the segment sum's upper triangle overflow ``exp``;
    masked before ``exp``, no NaN or Inf reaches the gradients."""
    xh, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in _ssd_inputs(2))
    dt = (dt * 40).requires_grad_()
    y = tssm.ssd_chunked(xh, dt, A * 4, Bm, Cm, D, 16)
    y.square().sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(dt.grad).all()


def test_conv_norm_and_softplus_match():
    """``_causal_dconv`` (fp32 inside, x's dtype out), ``rms_norm_gated``
    and the ``dt`` softplus at raw values up to 40 (torch returns v past
    20, where JAX's ``logaddexp`` rounds to v in fp32)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.1).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    z = rng.standard_normal((2, 7, 12)).astype(np.float32)
    _close(tssm._causal_dconv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jssm._causal_dconv(x, w, b))
    scale = {"scale": rng.standard_normal(12).astype(np.float32)}
    _close(tcm.rms_norm_gated(tcm.tree_map(torch.from_numpy, scale), torch.from_numpy(x),
                              torch.from_numpy(z)), jcm.rms_norm_gated(scale, x, z))
    raw = np.linspace(-30, 40, 701, dtype=np.float32)
    np.testing.assert_array_equal(torch.nn.functional.softplus(torch.from_numpy(raw))[raw > 15]
                                  .numpy(), np.asarray(jax.nn.softplus(raw))[raw > 15])
    _close(torch.nn.functional.softplus(torch.from_numpy(raw)), jax.nn.softplus(raw))


# ------------------------------------------------------------- Mamba2 block --

def _block(models, mode):
    jc, tc, fp, packed, tfp, tpk = models["mamba2_2_7b"]
    jc, tc = jc.replace(quant=JQC.replace(mode=mode)), tc.replace(quant=TQC.replace(mode=mode))
    jtree, ttree = (packed, tpk) if mode == "binary" else (fp, tfp)
    return (jc, tc, jax.tree.map(lambda t: t[0], jtree["mamba_layers"]["block"]),
            tcm.tree_index(ttree["mamba_layers"]["block"], 0))


@pytest.mark.parametrize("mode", ["dense", "binary", "fake_quant"])
def test_mamba2_block_matches(models, mode):
    """Forward, prefill (state and the pre-activation conv rows) and two
    decode steps writing the cache in place, the second with a mask."""
    jc, tc, jp, tp = _block(models, mode)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2, 64)).astype(np.float32)   # L=2 < width-1: zero-padded
    _close(tssm.mamba2_forward(tp, torch.from_numpy(x), tc),
           jax.jit(lambda p, v: jssm.mamba2_forward(p, v, jc))(jp, x))
    jy, jcache = jax.jit(lambda p, v: jssm.mamba2_prefill(p, v, jc))(jp, x)
    ty, tcache = tssm.mamba2_prefill(tp, torch.from_numpy(x), tc)
    _close(ty, jy)
    _check_cache(tcache, jcache)
    assert not tcache["conv_state"][:, 0].any()
    jdecode = jax.jit(lambda p, v, c, m: jssm.mamba2_decode(p, v, jc, c, update_mask=m))
    for mask in (None, np.array([True, False, True])):
        xi = rng.standard_normal((3, 1, 64)).astype(np.float32)
        jy, jcache = jdecode(jp, xi, jcache, mask)
        ty, same = tssm.mamba2_decode(tp, torch.from_numpy(xi), tc, tcache,
                                      update_mask=None if mask is None else torch.from_numpy(mask))
        assert same is tcache
        _close(ty, jy)
        _check_cache(tcache, jcache)


def test_update_mask_keeps_rows_bit_exact(models):
    """Rows outside the mask keep their state bit for bit; rows inside get
    what an unmasked decode gives them."""
    _, tc, _, tp = _block(models, "binary")
    rng = np.random.default_rng(5)
    cache = tssm.init_mamba2_cache(tc, 4, device="cpu")
    cache = tcm.tree_map(lambda t: torch.from_numpy(rng.standard_normal(t.shape)
                                                    .astype(np.float32)), cache)
    x = torch.from_numpy(rng.standard_normal((4, 1, 64)).astype(np.float32))
    before = tcm.tree_map(torch.clone, cache)
    full = tcm.tree_map(torch.clone, cache)
    y_full, _ = tssm.mamba2_decode(tp, x, tc, full)
    mask = torch.tensor([False, True, False, True])
    y, _ = tssm.mamba2_decode(tp, x, tc, cache, update_mask=mask)
    for key in ("ssm_state", "conv_state"):
        assert torch.equal(cache[key][~mask], before[key][~mask])
        assert torch.equal(cache[key][mask], full[key][mask])
        assert not torch.equal(full[key][mask], before[key][mask])
    assert torch.equal(y, y_full)


def test_prime_length_runs_chunk_one(models):
    """A prime L past the chunk degrades to chunk 1 and still equals JAX."""
    jc, tc, jp, tp = _block(models, "binary")
    x = np.random.default_rng(6).standard_normal((1, 17, 64)).astype(np.float32)
    jy, jcache = jax.jit(lambda p, v: jssm.mamba2_prefill(p, v, jc))(jp, x)
    ty, tcache = tssm.mamba2_prefill(tp, torch.from_numpy(x), tc)
    _close(ty, jy)
    _check_cache(tcache, jcache)


# ------------------------------------------------------------------------ LM --

@pytest.fixture(scope="module")
def decoded(models):
    """Per family: forward and prefill of 7 tokens at B=2 (max_len 16), then 3
    decode steps, the last masked to row 0, on both sides."""
    out = {}
    for name in ARCHS:
        jc, tc, _, packed, _, tpk = models[name]
        toks, steps = _tokens(2, 7, seed=1), _tokens(3, 2, seed=2)
        jf, _ = jax.jit(functools.partial(japi.forward, jc))(packed, {"tokens": toks})
        tf, _ = tapi.forward(tc, tpk, {"tokens": torch.from_numpy(toks)})
        jl, jcache = jax.jit(functools.partial(japi.prefill, jc, max_len=16))(packed, toks)
        tl, tcache = tapi.prefill(tc, tpk, torch.from_numpy(toks), max_len=16)
        rows = [(tf, jf, None, None), (tl, jl, tcm.tree_map(torch.clone, tcache), jcache)]
        jstep = jax.jit(functools.partial(japi.decode_step, jc))
        for i in range(3):
            mask = np.array([True, i < 2])
            batch = {"tokens": steps[i][:, None], "pos": np.full((2,), 7 + i, np.int32),
                     "update_mask": mask}
            jl, jcache = jstep(packed, dict(batch, cache=jcache))
            tl, tcache = tapi.decode_step(tc, tpk, {**{k: torch.from_numpy(v)
                                                       for k, v in batch.items()},
                                                    "cache": tcache})
            rows.append((tl, jl, tcm.tree_map(torch.clone, tcache), jcache))
        out[name] = rows
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_prefill_match(decoded, name):
    (tf, jf, _, _), (tl, jl, tcache, jcache) = decoded[name][:2]
    assert tuple(tf.shape) == (2, 7, 512)
    _close(tf, jf)
    _close(tl, jl)
    _check_cache(tcache, jcache)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match(decoded, name):
    """The last step's mask leaves row 1's state as the step before left it."""
    rows = decoded[name]
    for got, want, gcache, wcache in rows[2:]:
        assert tuple(got.shape) == (2, 1, 512)
        _close(got, want)
        _check_cache(gcache, wcache)
    mamba = (lambda c: c) if name == "mamba2_2_7b" else (lambda c: c["mamba"])
    for a, b in zip(tcm.tree_leaves(mamba(rows[-1][2])), tcm.tree_leaves(mamba(rows[-2][2]))):
        assert torch.equal(a[:, 1], b[:, 1]) and not torch.equal(a[:, 0], b[:, 0])


@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_match(models, name):
    """Shapes and dtypes; ``init_cache`` equal to JAX's; the module's own
    ``init_*_cache`` give one layer's (ssm) or the whole (hybrid) tree."""
    jc, tc, *_ = models[name]
    want = jax.tree.leaves(japi.cache_specs(jc, 3, 10))
    got = tcm.tree_leaves(tapi.cache_specs(tc, 3, 10))
    assert [tuple(s.shape) for s in got] == [s.shape for s in want]
    assert [str(s.dtype).split(".")[-1] for s in got] == [str(s.dtype) for s in want]
    init = tcm.tree_leaves(tapi.init_cache(tc, 3, 10, device="cpu"))
    for t, w in zip(init, jax.tree.leaves(japi.init_cache(jc, 3, 10))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    if name == "mamba2_2_7b":
        own = [t.shape for t in tcm.tree_leaves(tssm.init_mamba2_cache(tc, 3, device="cpu"))]
        assert own == [s.shape[1:] for s in want]
    else:
        own = [t.shape for t in tcm.tree_leaves(thyb.init_hybrid_cache(tc, 3, 10, device="cpu"))]
        assert own == [s.shape for s in want] and thyb.n_attn_points(tc) == 2


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_match_the_reference(name):
    """The port's own init in bf16 gives the reference's tree, shapes and
    dtypes (the dynamics fp32), no ``unembed`` table, and ``count_params``
    counts it."""
    jc, tc = _cfgs(name)
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    want = jax.eval_shape(lambda k: japi.init_params(jc, k), jax.random.PRNGKey(0))
    got = tapi.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(tcm.tree_map(lambda _: 0, got))
    assert [tuple(t.shape) for t in tcm.tree_leaves(got)] == \
        [s.shape for s in jax.tree.leaves(want)]
    assert [str(t.dtype).split(".")[-1] for t in tcm.tree_leaves(got)] == \
        [str(s.dtype) for s in jax.tree.leaves(want)]
    block = got["mamba_layers"]["block"]
    assert all(block[k].dtype == torch.float32 for k in ("conv_w", "conv_b", "A_log", "D",
                                                          "dt_bias"))
    assert "unembed" not in got
    assert sum(t.numel() for t in tcm.tree_leaves(got)) == tapi.count_params(tc)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_count_params_matches(name, size):
    jc, tc = jcb.get_config(name), tcb.get_config(name)
    if size == "reduced":
        jc, tc = jcb.reduced(jc), tcb.reduced(tc)
    assert tapi.count_params(tc) == japi.count_params(jc)
    assert tapi.count_params(tc, active_only=True) == tapi.count_params(tc)
    if size == "full":
        assert tapi.count_params(tc) == {"mamba2_2_7b": 2_702_579_200,
                                         "zamba2_7b": 6_662_132_944}[name]


@pytest.mark.parametrize("name", ARCHS)
def test_binarize_model_params_matches(models, name):
    """The packed bits byte-identical and the alphas allclose; the dynamics,
    the norms and the table stay fp, unchanged."""
    jc, tc, fp, packed, tfp, _ = models[name]
    got = tapi.binarize_model_params(tc, tfp)
    want = _np(packed)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(tcm.tree_map(lambda _: 0, got))
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        t = got
        for k in path:
            t = t[k.key]
        if w.dtype == np.uint8:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=str(path))
        else:
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-7, err_msg=str(path))
    block, src = got["mamba_layers"]["block"], tfp["mamba_layers"]["block"]
    for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert block[k] is src[k]
    assert block["norm"]["scale"] is src["norm"]["scale"]
    assert got["embed"]["table"] is tfp["embed"]["table"]
    assert "B_packed" in block["in_proj"] and "B_packed" in block["out_proj"]
    if name == "zamba2_7b":
        sh = got["shared"]
        assert all("B_packed" in p for p in (sh["in_proj"], sh["attn"]["wq"], sh["ffn"]["w_down"]))


# ---------------------------------------------------------------------- loss --

@pytest.mark.parametrize("name,mode", [("mamba2_2_7b", "fake_quant"), ("zamba2_7b", "dense")])
def test_loss_fn_and_grads_match(models, name, mode):
    jc, tc = _cfgs(name, mode)
    fp, tfp = models[name][2], models[name][4]
    toks = _tokens(2, 11, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (_, jm), jg = jax.jit(jax.value_and_grad(functools.partial(japi.loss_fn, jc),
                                             has_aux=True))(fp, batch)
    tg, tm = tsteps.loss_and_grads(functools.partial(tapi.loss_fn, tc), tfp,
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm) == {"loss", "ce_loss"}
    for k in jm:
        _close_rel(tm[k], jm[k])
    got, want = tcm.tree_leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_rel(g, w)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_runs_with_remat(name):
    """One fake-quant ``build_train_step`` step, each layer under
    ``torch.utils.checkpoint``: the loss finite, the in_proj moved."""
    from repro_torch.optim import adamw

    _, tc = _cfgs(name, "fake_quant")
    tc = tc.replace(remat=True)
    opt = adamw(1e-3)
    state = tsteps.init_train_state(tc, opt, device="cpu")
    before = state["params"]["mamba_layers"]["block"]["in_proj"]["w"].clone()
    toks = torch.from_numpy(_tokens(2, 9, seed=4)).long()
    state, met = tsteps.build_train_step(tc, opt)(state, {"tokens": toks[:, :-1],
                                                          "labels": toks[:, 1:]})
    assert met["skipped"] is False and bool(torch.isfinite(met["loss"]))
    assert not torch.equal(state["params"]["mamba_layers"]["block"]["in_proj"]["w"], before)


def test_hybrid_schedule_governs_each_layer_and_its_shared_block(models):
    """Schedules (1, 2, 1, 2) and (2, 1, 2, 1): the shared block after layer
    i takes entry i; each equals JAX in forward, prefill and decode, and a
    uniform schedule equals its int."""
    jc, tc, _, packed, _, tpk = models["zamba2_7b"]
    toks = _tokens(1, 6, seed=5)

    def fwd(**q):
        return tapi.forward(tc.replace(quant=TQC.replace(**q)), tpk,
                            {"tokens": torch.from_numpy(toks)})[0]

    assert torch.equal(fwd(m_schedule=(1, 1, 1, 1)), fwd(m_active=1))
    for sched in ((1, 2, 1, 2), (2, 1, 2, 1)):
        jq = jc.replace(quant=JQC.replace(m_schedule=sched))
        tq = tc.replace(quant=TQC.replace(m_schedule=sched))
        want, _ = jax.jit(functools.partial(japi.forward, jq))(packed, {"tokens": toks})
        _close(fwd(m_schedule=sched), want)
        jl, jcache = jax.jit(functools.partial(japi.prefill, jq, max_len=12))(packed, toks)
        tl, tcache = tapi.prefill(tq, tpk, torch.from_numpy(toks), max_len=12)
        _close(tl, jl)
        batch = {"tokens": np.array([[5]], np.int32), "pos": np.array([6], np.int32)}
        jl, jcache = jax.jit(functools.partial(japi.decode_step, jq))(packed,
                                                                      dict(batch, cache=jcache))
        tl, tcache = tapi.decode_step(tq, tpk, {**{k: torch.from_numpy(v)
                                                   for k, v in batch.items()}, "cache": tcache})
        _close(tl, jl)
        _check_cache(tcache, jcache)
    assert not torch.allclose(fwd(m_schedule=(1, 2, 1, 2)), fwd(m_schedule=(2, 1, 2, 1)))


# -------------------------------------------------------------------- Server --

SCENARIOS = {  # name -> (arch, Server kwargs, prompt lengths, m_active per request)
    "ssm_mixed_m": ("mamba2_2_7b", dict(max_batch=3), (4, 6, 4, 6), (None, 1, (1, 2, 1, 2), 2)),
    "ssm_tokenwise": ("mamba2_2_7b", dict(max_batch=2, prefill="tokenwise"), (4, 6, 5),
                      (None,) * 3),
    "hybrid_mixed_m": ("zamba2_7b", dict(max_batch=3), (4, 6, 4, 6), (None, 1, (2, 1, 2, 1), 2)),
}


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _serve(mod, cfg, params, kw, lens, modes):
    srv = mod.Server(cfg, params, max_len=32, **kw)
    reqs = [mod.Request(prompt=p, max_new_tokens=4, m_active=m)
            for p, m in zip(_prompts(lens), modes)]
    pending = list(reqs)
    while pending or any(s is not None for s in srv.slots):
        while pending and srv.admit(pending[0]):
            pending.pop(0)
        srv.step()
    return reqs, dict(srv.stats), srv.cache_sizes()


@pytest.fixture(scope="module")
def served(models):
    out = {}
    for name, (arch, kw, lens, modes) in SCENARIOS.items():
        jc, tc, _, packed, _, tpk = models[arch]
        out[name] = (_serve(jserve, jc, packed, kw, lens, modes),
                     _serve(tserve, tc, tpk, kw, lens, modes))
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_server_matches_the_reference(served, scenario):
    (jreqs, jstats, jsizes), (treqs, tstats, tsizes) = served[scenario]
    for j, t in zip(jreqs, treqs):
        assert t.done and t.out_tokens == j.out_tokens
        assert t.last_logits.dtype == np.float32 and t.last_logits.shape == (512,)
        np.testing.assert_allclose(t.last_logits, j.last_logits, rtol=2e-5, atol=5e-5)
    assert tstats == jstats
    assert tsizes == jsizes


def _state_rows(cfg, cache, slot):
    mamba = cache if cfg.family == "ssm" else cache["mamba"]
    return [t[:, slot].clone() for t in tcm.tree_leaves(mamba)]


@pytest.fixture(scope="module")
def dense_models():
    """name -> (port cfg, port fp tree) in fp32 with dense linears (the JAX
    package's ``test_serve_prefill`` setting)."""
    out = {}
    for name in ARCHS:
        jc, tc = _cfgs(name, "dense")
        out[name] = (tc, params_from_numpy(_np(japi.init_params(jc, jax.random.PRNGKey(0))),
                                           device="cpu"))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_bulk_matches_tokenwise(dense_models, name):
    """A 6-token prompt: the slot's cache rows after admission within 1e-5,
    the tokens equal and the last logits within rtol 2e-5 / atol 5e-5."""
    tc, tp = dense_models[name]
    prompt = np.array([3, 7, 11, 2, 9, 4], np.int32)
    out = {}
    for mode in ("bulk", "tokenwise"):
        srv = tserve.Server(tc, tp, max_batch=2, max_len=32, prefill=mode)
        req = tserve.Request(prompt=prompt.copy(), max_new_tokens=3)
        assert srv.admit(req)
        rows = [t[:, 0].clone() for t in tcm.tree_leaves(srv.cache)]
        srv.run_until_done()
        out[mode] = (rows, req)
    for a, b in zip(out["bulk"][0], out["tokenwise"][0]):
        _close(a, b.numpy())
    assert out["bulk"][1].out_tokens == out["tokenwise"][1].out_tokens
    np.testing.assert_allclose(out["bulk"][1].last_logits, out["tokenwise"][1].last_logits,
                               rtol=2e-5, atol=5e-5)
    assert tserve.Server(tc, tp, max_batch=1, max_len=32)._pad_safe is False


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mode", ["bulk", "tokenwise"])
def test_admission_leaves_other_slots_state_bit_exact(dense_models, name, mode):
    """Slot 0's recurrent state across slot 1's admission (bulk: a separate
    B=1 prefill; token-wise: the update mask) and across a decode group it
    is not in (slot 0 sits the round out)."""
    tc, tp = dense_models[name]
    srv = tserve.Server(tc, tp, max_batch=2, max_len=32, prefill=mode)
    assert srv.admit(tserve.Request(prompt=np.array([5, 6, 7], np.int32), max_new_tokens=4))
    before = _state_rows(tc, srv.cache, 0)
    assert srv.admit(tserve.Request(prompt=np.array([9, 8, 7, 6], np.int32), max_new_tokens=4))
    for b, a in zip(before, _state_rows(tc, srv.cache, 0)):
        assert torch.equal(a, b)
    other = _state_rows(tc, srv.cache, 1)
    srv.slots[0].done = True
    srv.step()
    assert srv.stats["decode_steps"] == 1
    for b, a in zip(before, _state_rows(tc, srv.cache, 0)):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in zip(other, _state_rows(tc, srv.cache, 1)))


@pytest.mark.parametrize("name", ARCHS)
def test_mixed_m_active_serves_like_isolated(models, name):
    """§IV-D for the recurrent families: a request in a mixed m_active batch
    gets the stream it gets alone (JAX ``tests/test_serve_prefill.py``)."""
    _, tc, _, _, _, tpk = models[name]
    prompt = np.array([1, 2, 3, 4], np.int32)
    srv = tserve.Server(tc, tpk, max_batch=3, max_len=32)
    r_full = tserve.Request(prompt=prompt.copy(), max_new_tokens=4)
    r_fast = tserve.Request(prompt=prompt.copy(), max_new_tokens=4, m_active=1)
    assert srv.admit(r_full) and srv.admit(r_fast)
    srv.run_until_done()
    for m, mixed in ((None, r_full), (1, r_fast)):
        solo_srv = tserve.Server(tc, tpk, max_batch=1, max_len=32)
        solo = tserve.Request(prompt=prompt.copy(), max_new_tokens=4, m_active=m)
        assert solo_srv.admit(solo)
        solo_srv.run_until_done()
        assert mixed.out_tokens == solo.out_tokens
        np.testing.assert_allclose(mixed.last_logits, solo.last_logits, rtol=1e-5, atol=1e-5)
    assert not np.allclose(r_fast.last_logits, r_full.last_logits)


# ------------------------------------------------------------------- convert --

def test_params_from_numpy_carries_a_bf16_mamba_tree():
    """A bf16 mamba2 tree (bf16 linears and norms, fp32 dynamics) crosses
    over bit for bit."""
    jc, _ = _cfgs("mamba2_2_7b")
    fp = _np(japi.init_params(jc.replace(dtype="bfloat16"), jax.random.PRNGKey(1)))
    got = params_from_numpy(fp, device="cpu")
    for path, w in jax.tree_util.tree_flatten_with_path(fp)[0]:
        t = got
        for k in path:
            t = t[k.key]
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    assert got["mamba_layers"]["block"]["in_proj"]["w"].shape == (4, 64, 2 * 128 + 2 * 16 + 8)


def test_get_config_resolves_both_families():
    for name, family in (("mamba2_2_7b", "ssm"), ("mamba2-2.7b", "ssm"),
                         ("zamba2_7b", "hybrid"), ("zamba2-7b", "hybrid")):
        assert tcb.get_config(name.replace(".", "_")).family == family


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    gen = torch.Generator().manual_seed(0)
    for name in ARCHS:
        _, tc = _cfgs(name)
        for call in (lambda: tapi.init_params(tc, gen),
                     lambda: tapi.init_cache(tc, 1, 8),
                     lambda: tssm.init_mamba2(gen, tc),
                     lambda: tssm.init_mamba_layers(gen, tc),
                     lambda: tssm.init_mamba2_cache(tc, 1)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    _, tc = _cfgs("zamba2_7b")
    for call in (lambda: thyb.init_hybrid(gen, tc), lambda: thyb.init_shared(gen, tc),
                 lambda: thyb.init_hybrid_cache(tc, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
