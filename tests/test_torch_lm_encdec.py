"""The port's enc-dec (Whisper) family and VLM image prefix (InternVL2)
against the JAX package, on the CPU: the sinusoidal positions, the encoder,
the teacher-forced forward, the cross K/V cache and decode, the VLM forward
with its prefix, the loss, binarization, parameter counts, the per-layer
schedule (ignored by the enc-dec walks in both packages) and ``Server``.

Reduced configs (``configs.base.reduced``: whisper 2 encoder + 2 decoder
layers with ``encoder_len`` 24, internvl2 2 layers with 8 image tokens;
d_model 64, 4 heads x 16), in float32 and in bfloat16, with
``QuantConfig(M=2, K_iters=2)`` in the mode a test names (binary unless
said).  Weights are drawn (and binarized) by the JAX package and cross
over by ``params_from_numpy``; inputs are numpy arrays from seeded
generators.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 (``tests/test_torch_lm_models.py``'s:
fp32 sums in another order); bf16 atol 2e-2 x max|want| (the encoder
output, logits and cache leaves): a bf16 value carries 8 significant bits,
so one rounding that lands on the other side of a tie moves an activation
by 2^-8 = 3.9e-3 of its size, and the two packages round the attention
operands, the fp32-to-bf16 casts of each linear's output and the residual
adds at different points (JAX keeps the attention operands in bf16, the
port widens them; the summation orders differ), which compounds over the
4 layers to a few such steps; losses and gradients rtol 1e-5 with a floor
of 1e-5 x the leaf's largest entry (fp32); ``Server`` tokens equal and last
logits rtol 2e-5 / atol 5e-5 (the JAX serving tests'); packed bits and
``count_params`` exact.
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
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core import binlinear as tbl
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as ttf

jax.config.update("jax_platform_name", "cpu")

JQC = jbl.QuantConfig(mode="binary", M=2, K_iters=2)
TQC = tbl.QuantConfig(mode="binary", M=2, K_iters=2)
RTOL, ATOL = 1e-5, 1e-5
BF16_REL = 2e-2
ARCHS = ("whisper_medium", "internvl2_2b")
DTYPES = ("float32", "bfloat16")


def _cfgs(name, dtype="float32", mode="binary"):
    jc = jcb.reduced(jcb.get_config(name)).replace(dtype=dtype, quant=JQC.replace(mode=mode))
    tc = tcb.reduced(tcb.get_config(name)).replace(dtype=dtype, quant=TQC.replace(mode=mode))
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, dtype="float32"):
    """fp32: rtol 1e-5 / atol 1e-5; bf16: atol 2e-2 x max|want| (module
    docstring).  The dtypes must agree."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got, want = got.detach().to(torch.float32).numpy(), want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_REL * np.abs(want).max())


def _close_rel(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _embeds(B, S, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, 64)).astype(np.float32)
    return x, torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def models():
    """(name, dtype) -> (jax fp tree, jax packed tree, port fp tree, port
    packed tree)."""
    out = {}
    for name in ARCHS:
        for dtype in DTYPES:
            jc, _ = _cfgs(name, dtype)
            fp = jax.jit(functools.partial(japi.init_params, jc))(jax.random.PRNGKey(0))
            packed = jax.jit(functools.partial(japi.binarize_model_params, jc))(fp)
            out[name, dtype] = (fp, packed, params_from_numpy(_np(fp), device="cpu"),
                                params_from_numpy(_np(packed), device="cpu"))
    return out


def _jax_forward(jc, params, batch):
    return jax.jit(functools.partial(japi.forward, jc))(params, batch)


def _sides(models, name, dtype, mode):
    """(jax cfg, port cfg, jax tree, port tree) in ``mode``: the packed
    trees for binary, the fp trees otherwise."""
    jc, tc = _cfgs(name, dtype, mode)
    fp, packed, tfp, tpk = models[name, dtype]
    return (jc, tc, packed, tpk) if mode == "binary" else (jc, tc, fp, tfp)


# ------------------------------------------------------------------ positions --

@pytest.mark.parametrize("length,dim", [(24, 64), (1500, 1024)])
def test_sinusoidal_positions_match(length, dim):
    """fp32, the reduced and the full whisper encoder; the angle reaches
    1499 rad at full length, where one ulp of fp32 is 1.2e-4, so the full
    size is held to atol 1e-4 (the two packages' ``pow`` and ``sin`` may
    round differently), the reduced one to 1e-5."""
    got = tcm.sinusoidal_positions(length, dim)
    want = np.asarray(jcm.sinusoidal_positions(length, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (length, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 if length < 100 else 1e-4)


# -------------------------------------------------------------------- enc-dec --

@pytest.mark.parametrize("mode,dtype", [("dense", "float32"), ("binary", "float32"),
                                        ("fake_quant", "float32"), ("dense", "bfloat16"),
                                        ("binary", "bfloat16")])
def test_encdec_matches(models, mode, dtype):
    """``encode``, the teacher-forced ``forward``, ``init_encdec_cache`` with
    frame embeddings (cross K/V of each decoder layer) and 4 decode steps at
    two rows' own positions, the self-KV written in place.  fake_quant runs
    in fp32 only: its JAX reference compiles Algorithm 2 into every linear
    (20 s a program on the CPU)."""
    jc, tc, jp, tp = _sides(models, "whisper_medium", dtype, mode)
    fe, tfe = _embeds(2, jc.encoder_len, dtype)
    jfe = jnp.asarray(fe).astype(jc.jnp_dtype)
    toks = _tokens(2, 6, seed=2)

    @jax.jit
    def reference(p, f, t):     # one program: XLA shares the three encoder passes
        return (jed.encode(p, jc, f), japi.forward(jc, p, {"tokens": t, "frame_embeds": f})[0],
                jed.init_encdec_cache(p, jc, 2, 12, frame_embeds=f))

    jenc, jlogits, jcache = reference(jp, jfe, toks)
    _close(ted.encode(tp, tc, tfe), jenc, dtype)
    _close(tapi.forward(tc, tp, {"tokens": torch.from_numpy(toks), "frame_embeds": tfe})[0],
           jlogits, dtype)
    tcache = ted.init_encdec_cache(tp, tc, 2, 12, frame_embeds=tfe, device="cpu")
    for key in ("cross_k", "cross_v"):
        _close(tcache[key], jcache[key], dtype)
    assert not tcache["self"]["k"].any()
    steps = _tokens(4, 2, seed=3)
    jstep = jax.jit(functools.partial(japi.decode_step, jc))
    for i in range(4):
        batch = {"tokens": steps[i][:, None], "pos": np.array([i, 3 + i], np.int32)}
        jl, jcache = jstep(jp, dict(batch, cache=jcache))
        tl, same = tapi.decode_step(tc, tp, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                                             "cache": tcache})
        assert same is tcache
        _close(tl, jl, dtype)
        for g, w in zip(tcm.tree_leaves(tcache), jax.tree.leaves(jcache)):
            _close(g, w, dtype)


def test_encdec_ignores_a_per_layer_schedule(models):
    """Neither package's enc-dec walks resolve ``m_schedule``: with (1, 2)
    every layer runs all M levels, bit for bit the config without it, and
    the port equals JAX there; a uniform ``m_active`` is honoured."""
    jc, tc, jp, tp = _sides(models, "whisper_medium", "float32", "binary")
    fe, tfe = _embeds(1, jc.encoder_len, "float32")
    toks = _tokens(1, 5, seed=4)

    def fwd(**q):
        return tapi.forward(tc.replace(quant=TQC.replace(**q)), tp,
                            {"tokens": torch.from_numpy(toks), "frame_embeds": tfe})[0]

    sched = fwd(m_schedule=(1, 2))
    assert torch.equal(sched, fwd()) and torch.equal(sched, fwd(m_active=2))
    assert not torch.allclose(fwd(m_active=1), sched)
    want, _ = _jax_forward(jc.replace(quant=JQC.replace(m_schedule=(1, 2))), jp,
                           {"tokens": toks, "frame_embeds": fe})
    _close(sched, want)
    cache = ted.init_encdec_cache(tp, tc, 1, 8, frame_embeds=tfe, device="cpu")
    batch = {"tokens": torch.tensor([[3]]), "pos": torch.tensor([0])}
    lg = [tapi.decode_step(tc.replace(quant=TQC.replace(**q)), tp,
                           dict(batch, cache=tcm.tree_map(torch.clone, cache)))[0]
          for q in ({"m_schedule": (1, 2)}, {})]
    assert torch.equal(lg[0], lg[1])


# ------------------------------------------------------------------------ VLM --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("prefix", ["patch_embeds", "none"])
def test_vlm_forward_matches(models, prefix, dtype):
    """With the prefix: ``api.forward`` (logits of the tokens only) equals
    JAX's, and a prefix of zeros is not the same as none.  Without it: the
    LM stack equals JAX's, and ``api.forward`` raises ``KeyError`` as JAX's
    does."""
    jc, tc, jp, tp = _sides(models, "internvl2_2b", dtype, "binary")
    toks = _tokens(2, 7, seed=5)
    tt = torch.from_numpy(toks)
    if prefix == "none":
        _close(ttf.lm_forward(tp, tc, tt)[0],
               jax.jit(lambda p, t: jtf.lm_forward(p, jc, t)[0])(jp, toks), dtype)
        with pytest.raises(KeyError):
            tapi.forward(tc, tp, {"tokens": tt})
        with pytest.raises(KeyError):
            japi.forward(jc, jp, {"tokens": toks})
        return
    pe, tpe = _embeds(2, jc.n_image_tokens, dtype, seed=6)
    got, _ = tapi.forward(tc, tp, {"tokens": tt, "patch_embeds": tpe})
    want, _ = _jax_forward(jc, jp, {"tokens": toks,
                                    "patch_embeds": jnp.asarray(pe).astype(jc.jnp_dtype)})
    assert tuple(got.shape) == (2, 7, 512)
    _close(got, want, dtype)
    zeros, _ = tapi.forward(tc, tp, {"tokens": tt, "patch_embeds": torch.zeros_like(tpe)})
    assert not torch.allclose(zeros, ttf.lm_forward(tp, tc, tt)[0])


def test_vlm_schedule_governs_each_layer(models):
    """The VLM walks the LM stack, which resolves a per-layer schedule."""
    jc, tc, jp, tp = _sides(models, "internvl2_2b", "float32", "binary")
    toks = _tokens(1, 5, seed=7)
    pe, tpe = _embeds(1, jc.n_image_tokens, "float32", seed=8)

    def fwd(**q):
        return tapi.forward(tc.replace(quant=TQC.replace(**q)), tp,
                            {"tokens": torch.from_numpy(toks), "patch_embeds": tpe})[0]

    mixed = fwd(m_schedule=(1, 2))
    assert torch.equal(fwd(m_schedule=(1, 1)), fwd(m_active=1))
    assert not torch.allclose(mixed, fwd(m_active=1)) and not torch.allclose(mixed, fwd())
    want, _ = _jax_forward(jc.replace(quant=JQC.replace(m_schedule=(1, 2))), jp,
                           {"tokens": toks, "patch_embeds": pe})
    _close(mixed, want)


@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_match(name):
    """Shapes and dtypes, and ``init_cache`` equal to JAX's zeros: the VLM
    cache ``n_image_tokens`` rows longer, the enc-dec cross K/V at
    ``encoder_len``."""
    jc, tc = _cfgs(name, "bfloat16")
    want = jax.tree.leaves(japi.cache_specs(jc, 3, 10))
    got = tcm.tree_leaves(tapi.cache_specs(tc, 3, 10))
    assert [tuple(s.shape) for s in got] == [s.shape for s in want]
    assert [str(s.dtype).split(".")[-1] for s in got] == [str(s.dtype) for s in want]
    assert got[0].shape[2] == (24 if name == "whisper_medium" else 18)
    init = tcm.tree_leaves(tapi.init_cache(tc, 3, 10, device="cpu"))
    assert all(not t.any() for t in init) and len(init) == len(want)


# -------------------------------------------------------------- loss, params --

@pytest.mark.parametrize("name,mode", [("whisper_medium", "dense"),
                                       ("internvl2_2b", "fake_quant")])
def test_loss_fn_and_grads_match(models, name, mode):
    jc, tc, jp, tp = _sides(models, name, "float32", mode)
    toks = _tokens(2, 9, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key = "frame_embeds" if name == "whisper_medium" else "patch_embeds"
    emb, temb = _embeds(2, jc.encoder_len if key == "frame_embeds" else jc.n_image_tokens,
                        "float32", seed=10)
    (_, jm), jg = jax.jit(jax.value_and_grad(functools.partial(japi.loss_fn, jc),
                                             has_aux=True))(jp, dict(batch, **{key: emb}))
    tg, tm = tsteps.loss_and_grads(functools.partial(tapi.loss_fn, tc), tp,
                                   {**{k: torch.from_numpy(v) for k, v in batch.items()},
                                    key: temb})
    assert set(tm) == set(jm) == {"loss", "ce_loss"}
    for k in jm:
        _close_rel(tm[k], jm[k])
    got, want = tcm.tree_leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_rel(g, w)


@pytest.mark.parametrize("name", ARCHS)
def test_binarize_model_params_matches(models, name):
    """The packed bits byte-identical and the alphas allclose; the norms
    and the tables stay fp, unchanged."""
    _, tc = _cfgs(name)
    _, packed, tfp, _ = models[name, "float32"]
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
    assert got["embed"]["table"] is tfp["embed"]["table"]
    stack = got["dec_layers"] if name == "whisper_medium" else got["layers"]
    assert "B_packed" in stack["attn"]["wq"] and "B_packed" in stack["ffn"]["w_down"]
    if name == "whisper_medium":
        assert "B_packed" in got["enc_layers"]["ffn"]["w_up"]
        assert "B_packed" in stack["xattn"]["wk"]


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_match_the_reference(name):
    """The port's own init in bf16 gives the reference's tree, shapes and
    dtypes, and ``count_params`` counts it."""
    jc, tc = _cfgs(name, "bfloat16")
    want = jax.eval_shape(lambda k: japi.init_params(jc, k), jax.random.PRNGKey(0))
    got = tapi.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(tcm.tree_map(lambda _: 0, got))
    assert [tuple(t.shape) for t in tcm.tree_leaves(got)] == \
        [s.shape for s in jax.tree.leaves(want)]
    assert all(t.dtype == torch.bfloat16 for t in tcm.tree_leaves(got))
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
        assert tapi.count_params(tc) == {"whisper_medium": 757_877_760,
                                         "internvl2_2b": 1_889_146_880}[name]


# -------------------------------------------------------------------- Server --

SCENARIOS = {  # name -> (arch, dtype, Server kwargs, prompt lengths, m_active per request)
    "whisper_mixed_m": ("whisper_medium", "float32", dict(max_batch=3), (4, 6, 3, 5),
                        (None, 1, (1, 2), 2)),
    "internvl2_mixed_m": ("internvl2_2b", "float32", dict(max_batch=3), (4, 6, 3, 5),
                          (None, 1, (1, 2), 2)),
}


def _serve(mod, cfg, params, kw, lens, modes):
    rng = np.random.default_rng(11)
    srv = mod.Server(cfg, params, max_len=16, **kw)
    reqs = [mod.Request(prompt=rng.integers(0, 512, n).astype(np.int32), max_new_tokens=3,
                        m_active=m) for n, m in zip(lens, modes)]
    pending = list(reqs)
    while pending or any(s is not None for s in srv.slots):
        while pending and srv.admit(pending[0]):
            pending.pop(0)
        srv.step()
    return reqs, dict(srv.stats), srv.cache_sizes()


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_server_matches_the_reference(models, scenario):
    """Token-wise admission, slots freed and reused, mixed m_active; the
    enc-dec cross K/V are the zeros of ``init_cache`` on both sides."""
    arch, dtype, kw, lens, modes = SCENARIOS[scenario]
    jc, tc, jp, tp = _sides(models, arch, dtype, "binary")
    (jreqs, jstats, jsizes), (treqs, tstats, tsizes) = (
        _serve(jserve, jc, jp, kw, lens, modes), _serve(tserve, tc, tp, kw, lens, modes))
    for j, t in zip(jreqs, treqs):
        assert t.done and t.out_tokens == j.out_tokens
        assert t.last_logits.dtype == np.float32 and t.last_logits.shape == (512,)
        np.testing.assert_allclose(t.last_logits, j.last_logits, rtol=2e-5, atol=5e-5)
    assert tstats == jstats and tstats["bulk_prefills"] == 0
    assert tstats["tokenwise_prefill_steps"] == sum(n - 1 for n in lens)
    assert tsizes == jsizes


@pytest.mark.parametrize("name", ARCHS)
def test_bulk_prefill_raises(models, name):
    """No bulk prefill for either family, in either package: ``Server``
    refuses ``prefill="bulk"``, ``api.prefill`` and ``scatter_cache`` raise."""
    jc, tc, jp, tp = _sides(models, name, "float32", "binary")
    for mod, cfg, params in ((jserve, jc, jp), (tserve, tc, tp)):
        with pytest.raises(ValueError, match="bulk prefill"):
            mod.Server(cfg, params, max_batch=1, max_len=8, prefill="bulk")
    with pytest.raises(NotImplementedError, match="bulk prefill"):
        japi.prefill(jc, jp, _tokens(1, 3), max_len=8)
    with pytest.raises(NotImplementedError, match="bulk prefill"):
        tapi.prefill(tc, tp, torch.from_numpy(_tokens(1, 3)), max_len=8)
    cache = tapi.init_cache(tc, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        tapi.scatter_cache(tc, cache, 0, cache)


# ------------------------------------------------------------------- configs --

def test_get_config_resolves_both_families():
    for name, family in (("whisper_medium", "encdec"), ("whisper-medium", "encdec"),
                         ("internvl2_2b", "vlm"), ("internvl2-2b", "vlm")):
        assert tcb.get_config(name).family == family


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    gen = torch.Generator().manual_seed(0)
    for name in ARCHS:
        _, tc = _cfgs(name)
        for call in (lambda: tapi.init_params(tc, gen), lambda: tapi.init_cache(tc, 1, 8)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    _, tc = _cfgs("whisper_medium")
    for call in (lambda: ted.init_encdec(gen, tc), lambda: ted.init_enc_layer(gen, tc),
                 lambda: ted.init_dec_layer(gen, tc),
                 lambda: ted.init_encdec_cache({}, tc, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
