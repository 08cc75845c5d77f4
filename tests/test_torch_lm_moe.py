"""The port's MoE family (DeepSeek-V3 and grok-1) against the JAX package, on
the CPU: the dispatch, the MoE layer, MLA, the LM with its leading dense
stack and MTP head, the loss, the per-layer schedule across both stacks,
and ``Server``.

Reduced configs (``configs.base.reduced``: 2 layers, d_model 64, 4 experts
top-2, DeepSeek with 1 leading dense layer, MLA ranks 32, MTP depth 1),
dtype float32, ``QuantConfig(mode="binary", M=2, K_iters=2)`` unless a
test names another mode.  ``deepseek_noq`` is DeepSeek without q-LoRA
(``q_lora_rank`` 0, the ``wq`` branch).  Weights are drawn (and binarized)
by the JAX package and cross over by ``params_from_numpy``; inputs are
numpy arrays from seeded generators.  Each JAX reference runs once per
module where several tests read it.

Tolerances: dispatch tables, slots and expert ids exact; the count of
dropped picks exact (``dropped_frac`` within rtol 1e-6: a mean's last bit); a layer's output and the load-balance term rtol 1e-5 / atol 1e-5;
logits and cache leaves rtol 1e-5 / atol 1e-5 (fp32 sums in another order,
|logits| < 1); losses and gradients rtol 1e-5 with a floor of 1e-5 x the
leaf's largest entry (``test_torch_training.py``'s); ``Server`` tokens
equal and last logits rtol 2e-5 / atol 5e-5 (the JAX serving tests').
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
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core import binlinear as tbl
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

jax.config.update("jax_platform_name", "cpu")

JQC = jbl.QuantConfig(mode="binary", M=2, K_iters=2)
TQC = tbl.QuantConfig(mode="binary", M=2, K_iters=2)
RTOL, ATOL = 1e-5, 1e-5
ARCHS = ("deepseek_v3_671b", "grok_1_314b", "deepseek_noq")


def _cfgs(name, mode="binary"):
    arch = "deepseek_v3_671b" if name == "deepseek_noq" else name
    jc = jcb.reduced(jcb.get_config(arch)).replace(dtype="float32",
                                                   quant=JQC.replace(mode=mode))
    tc = tcb.reduced(tcb.get_config(arch)).replace(dtype="float32",
                                                   quant=TQC.replace(mode=mode))
    if name == "deepseek_noq":
        jc, tc = jc.replace(q_lora_rank=0), tc.replace(q_lora_rank=0)
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """Leaves in jax.tree.leaves' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol)


def _close_rel(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


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


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ dispatch --

@pytest.mark.parametrize("T,k,E,capacity,seed", [
    (6, 2, 4, 2, 0), (9, 2, 4, 1, 1), (64, 8, 256, 2, 2), (8, 8, 256, 1, 3),
    (5, 2, 8, 4, 4)])
def test_dispatch_indices_match(T, k, E, capacity, seed):
    """Seeded expert ids (distinct within a token, as top_k gives them) and
    a forced overflow: expert 0 picked first by every token."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    for forced in (False, True):
        if forced:
            ids[:, 0] = 0
            ids[:, 1:] = np.where(ids[:, 1:] == 0, 1 + np.arange(k - 1), ids[:, 1:])
        jd, js = jmoe._dispatch_indices(jnp.asarray(ids), E, capacity)
        td, ts = tmoe._dispatch_indices(torch.from_numpy(ids).long(), E, capacity)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if forced:
            assert int((ts[:, 0] < 0).sum()) == T - capacity   # the overflow dropped


# ----------------------------------------------------------------- MoE layer --

def _moe_inputs(name, mode, models):
    jc, tc, fp, packed, tfp, tpk = models[name]
    jc, tc = jc.replace(quant=JQC.replace(mode=mode)), tc.replace(quant=TQC.replace(mode=mode))
    jtree, ttree = (packed, tpk) if mode == "binary" else (fp, tfp)
    jl = jax.tree.map(lambda t: t[0], jtree["layers"]["moe"])
    return jc, tc, jl, tcm.tree_index(ttree["layers"]["moe"], 0)


def _same_drops(taux, jaux, picks: int) -> int:
    """The same number of dropped picks on both sides (``dropped_frac`` is
    a mean, whose last bit depends on how each side divides); returns it."""
    t, j = float(taux["dropped_frac"]), float(jaux["dropped_frac"])
    assert round(t * picks) == round(j * picks)
    np.testing.assert_allclose(t, j, rtol=1e-6)
    return round(t * picks)


@pytest.mark.parametrize("name", ["deepseek_v3_671b", "grok_1_314b"])
@pytest.mark.parametrize("mode", ["dense", "binary", "fake_quant"])
@pytest.mark.parametrize("B,S", [(2, 7), (5, 1)])
def test_moe_ffn_matches(models, name, mode, B, S):
    """The layer at S > 1 (per-row dispatch, 4 slots per expert) and S = 1
    (global dispatch across the batch, 3 slots): output, aux and the
    router's expert ids."""
    jc, tc, jl, tl = _moe_inputs(name, mode, models)
    x = np.random.default_rng(B * S).standard_normal((B, S, 64)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jl, jnp.asarray(x), jc)
    ty, taux = tmoe.moe_ffn(tl, torch.from_numpy(x), tc)
    _close(ty, jy)
    G, Sg = (1, B) if S == 1 else (B, S)
    _same_drops(taux, jaux, G * Sg * tc.top_k)
    _close(taux["load_balance_loss"], jaux["load_balance_loss"])
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", jnp.asarray(x).reshape(G, Sg, 64),
                                      jl["router"]["w"]), axis=-1)
    np.testing.assert_array_equal(tmoe.route(tl, torch.from_numpy(x), tc)[2].numpy(),
                                  np.asarray(jax.lax.top_k(probs, tc.top_k)[1]))


def test_moe_drops_tokens_at_decode(models):
    """At S = 1 the 3 rows x top-2 picks compete for 1 slot per expert of 4:
    at least 2 of the 6 picks drop, on both sides alike."""
    jc, tc, jl, tl = _moe_inputs("deepseek_v3_671b", "binary", models)
    x = np.random.default_rng(5).standard_normal((3, 1, 64)).astype(np.float32)
    _, jaux = jmoe.moe_ffn(jl, jnp.asarray(x), jc)
    _, taux = tmoe.moe_ffn(tl, torch.from_numpy(x), tc)
    assert _same_drops(taux, jaux, 6) >= 2


def test_routed_experts_get_gradients(models):
    """Autograd reaches the router (through the gate values and the
    load-balance term) and every expert bank through the index dispatch."""
    _, tc, _, tl = _moe_inputs("deepseek_v3_671b", "dense", models)
    tl = tcm.tree_map(lambda t: t.clone().requires_grad_(), tl)
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(0))
    y, aux = tmoe.moe_ffn(tl, x, tc)
    (y.square().sum() + aux["load_balance_loss"]).backward()
    for path in (("router", "w"), ("w_gate",), ("w_up",), ("w_down",), ("shared", "w_up", "w")):
        t = tl
        for k in path:
            t = t[k]
        assert t.grad is not None and float(t.grad.abs().sum()) > 0, path


# ----------------------------------------------------------------------- MLA --

@pytest.mark.parametrize("name", ["deepseek_v3_671b", "deepseek_noq"])
def test_mla_forward_prefill_decode_match(models, name):
    """MLA with and without q-LoRA: the forward, the prefill with its latent
    cache, then 2 absorbed decode steps writing the cache in place."""
    jc, tc, _, packed, _, tpk = models[name]
    jp = jax.tree.map(lambda t: t[0], packed["layers"]["attn"])
    tp = tcm.tree_index(tpk["layers"]["attn"], 0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    _close(tattn.mla_forward(tp, torch.from_numpy(x), tc), jattn.mla_forward(jp, x, jc))
    jy, jcache = jattn.mla_prefill(jp, x, jc, max_len=12)
    ty, tcache = tattn.mla_prefill(tp, torch.from_numpy(x), tc, max_len=12)
    _close(ty, jy)
    for key in ("c_kv", "k_rope"):
        _close(tcache[key], jcache[key])
    for i in range(2):
        xi = rng.standard_normal((2, 1, 64)).astype(np.float32)
        pos = np.array([6 + i, 3 + i], np.int32)
        jy, jcache = jattn.mla_decode(jp, xi, jc, jcache, pos)
        ty, same = tattn.mla_decode(tp, torch.from_numpy(xi), tc, tcache,
                                    torch.from_numpy(pos))
        assert same is tcache
        _close(ty, jy)
        for key in ("c_kv", "k_rope"):
            _close(tcache[key], jcache[key])


# ------------------------------------------------------------------------ LM --

@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches(models, name):
    jc, tc, _, packed, _, tpk = models[name]
    toks = _tokens(2, 9)
    want, jaux = jax.jit(functools.partial(japi.forward, jc))(packed, {"tokens": toks})
    got, aux = tapi.forward(tc, tpk, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    _close(aux["load_balance_loss"], jaux["load_balance_loss"])


def test_mtp_logits_match(models):
    jc, tc, fp, _, tfp, _ = models["deepseek_v3_671b"]
    jc, tc = jc.replace(quant=JQC.replace(mode="dense")), tc.replace(quant=TQC.replace(
        mode="dense"))
    toks = _tokens(2, 8, seed=5)
    jh, _ = jtf.lm_hidden(fp, jc, toks)
    th, _ = ttf.lm_hidden(tfp, tc, torch.from_numpy(toks))
    _close(th, jh)
    got = ttf.mtp_logits(tfp, tc, th, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 7, 512)
    _close(got, jtf.mtp_logits(fp, jc, jh, toks))


def _check_cache(got, want):
    assert len(_leaves(got)) == len(jax.tree.leaves(want))
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.fixture(scope="module")
def decoded(models):
    """Per arch: prefill of 6 tokens at B=2 (max_len 16), then 3 decode
    steps (capacity 1 slot per expert: picks drop), on both sides."""
    out = {}
    for name in ARCHS:
        jc, tc, _, packed, _, tpk = models[name]
        toks = _tokens(2, 6, seed=1)
        steps = _tokens(3, 2, seed=2)
        jl, jcache = jax.jit(functools.partial(japi.prefill, jc, max_len=16))(packed, toks)
        tl, tcache = tapi.prefill(tc, tpk, torch.from_numpy(toks), max_len=16)
        rows = [(tl, jl, tcm.tree_map(torch.clone, tcache), jcache)]   # decode writes in place
        jstep = jax.jit(functools.partial(japi.decode_step, jc))
        for i in range(3):
            pos = np.full((2,), 6 + i, np.int32)
            tok = steps[i][:, None]
            jl, jcache = jstep(packed, {"tokens": tok, "pos": pos, "cache": jcache})
            tl, tcache = tapi.decode_step(tc, tpk, {"tokens": torch.from_numpy(tok),
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
    assert ("dense_layers" in gcache) == (name != "grok_1_314b")


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match(decoded, name):
    for got, want, gcache, wcache in decoded[name][1:]:
        assert tuple(got.shape) == (2, 1, 512)
        _close(got, want)
        _check_cache(gcache, wcache)


@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_match(models, name):
    jc, tc, *_ = models[name]
    want = jax.tree.leaves(japi.cache_specs(jc, 3, 10))
    got = _leaves(tapi.cache_specs(tc, 3, 10))
    assert [tuple(s.shape) for s in got] == [s.shape for s in want]
    assert [str(s.dtype).split(".")[-1] for s in got] == [str(s.dtype) for s in want]
    init = _leaves(tapi.init_cache(tc, 3, 10, device="cpu"))
    for t, w in zip(init, jax.tree.leaves(japi.init_cache(jc, 3, 10))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_match_the_reference(name):
    """The port's own init gives the reference's tree, shapes and dtypes (the
    router in fp32 under a bf16 config), and ``count_params`` counts it."""
    jc, tc = _cfgs(name)
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    want = jax.eval_shape(lambda k: japi.init_params(jc, k), jax.random.PRNGKey(0))
    got = tapi.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree.structure(tcm.tree_map(lambda _: 0, got))
    assert [tuple(t.shape) for t in _leaves(got)] == [s.shape for s in jax.tree.leaves(want)]
    assert [str(t.dtype).split(".")[-1] for t in _leaves(got)] == \
        [str(s.dtype) for s in jax.tree.leaves(want)]
    assert got["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert sum(t.numel() for t in _leaves(got)) == tapi.count_params(tc)


@pytest.mark.parametrize("name", ["deepseek_v3_671b", "grok_1_314b"])
@pytest.mark.parametrize("size", ["full", "reduced", "noq"])
def test_count_params_matches(name, size):
    jc, tc = jcb.get_config(name), tcb.get_config(name)
    if size != "full":
        jc, tc = jcb.reduced(jc), tcb.reduced(tc)
    if size == "noq":
        jc, tc = jc.replace(q_lora_rank=0), tc.replace(q_lora_rank=0)
    for active in (False, True):
        assert tapi.count_params(tc, active_only=active) == \
            japi.count_params(jc, active_only=active)
    assert tapi.count_params(tc, active_only=True) < tapi.count_params(tc)


@pytest.mark.parametrize("name", ["deepseek_v3_671b", "grok_1_314b"])
def test_binarize_model_params_matches(models, name):
    """Given the same fp tree, the packed bits are byte-identical and the
    alphas allclose; the router, ``wuk``/``wuv``, the norms and the routed
    expert banks stay fp, unchanged."""
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
    moe = got["layers"]["moe"]
    kept = [moe["router"]["w"], moe["w_gate"], moe["w_up"], moe["w_down"]]
    src = [tfp["layers"]["moe"][k] for k in ("w_gate", "w_up", "w_down")]
    assert all(a is b for a, b in zip(kept[1:], src))
    assert torch.equal(kept[0], tfp["layers"]["moe"]["router"]["w"])
    assert "B_packed" in got["layers"]["attn"]["wo"]
    if tc.use_mla:
        for k in ("wuk", "wuv"):
            assert torch.equal(got["layers"]["attn"][k]["w"], tfp["layers"]["attn"][k]["w"])
        assert "B_packed" in moe["shared"]["w_down"] and "B_packed" in got["mtp"]["proj"]
        assert "B_packed" in got["dense_layers"]["ffn"]["w_gate"]


# ---------------------------------------------------------------------- loss --

@pytest.mark.parametrize("name", ["deepseek_v3_671b", "grok_1_314b"])
@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_loss_fn_and_grads_match(models, name, mode):
    """The four metrics (``ce_loss``, ``load_balance_loss`` x 0.01,
    ``mtp_loss`` x 0.3 for DeepSeek, ``loss``) and every gradient."""
    jc, tc = _cfgs(name, mode)
    fp, tfp = models[name][2], models[name][4]
    toks = np.random.default_rng(3).integers(0, 512, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, jm), jg = jax.jit(jax.value_and_grad(functools.partial(japi.loss_fn, jc),
                                              has_aux=True))(fp, batch)
    tg, tm = tsteps.loss_and_grads(functools.partial(tapi.loss_fn, tc), tfp,
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm) == ({"loss", "ce_loss", "load_balance_loss"}
                                  | ({"mtp_loss"} if tc.mtp_depth else set()))
    for k in jm:
        _close_rel(tm[k], jm[k])
    got, want = tcm.tree_leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_rel(g, w)


def test_train_step_runs_with_remat():
    """``build_train_step`` on reduced DeepSeek-V3 with remat, fake-quant:
    the MoE aux and the MTP head pass through ``torch.utils.checkpoint``."""
    from repro_torch.optim import adamw

    _, tc = _cfgs("deepseek_v3_671b", "fake_quant")
    tc = tc.replace(remat=True)
    opt = adamw(1e-3)
    state = tsteps.init_train_state(tc, opt, device="cpu")
    before = state["params"]["layers"]["moe"]["w_up"].clone()
    toks = torch.from_numpy(_tokens(2, 9, seed=4)).long()
    state, met = tsteps.build_train_step(tc, opt)(state, {"tokens": toks[:, :-1],
                                                          "labels": toks[:, 1:]})
    assert met["skipped"] is False and int(state["step"]) == 1
    assert all(bool(torch.isfinite(met[k])) for k in ("loss", "mtp_loss", "load_balance_loss"))
    assert not torch.equal(state["params"]["layers"]["moe"]["w_up"], before)


# ------------------------------------------------------------------ schedule --

def test_schedule_indexes_the_dense_stack_then_the_moe_stack(models):
    """DeepSeek's layer 0 is the leading dense layer, layer 1 the MoE layer:
    schedules (1, 2) and (2, 1) differ from each other and from the uniform
    counts, and each matches the JAX package in forward, prefill and decode."""
    jc, tc, _, packed, _, tpk = models["deepseek_v3_671b"]
    toks = _tokens(1, 7, seed=4)

    def fwd(**q):
        return tapi.forward(tc.replace(quant=TQC.replace(**q)), tpk,
                            {"tokens": torch.from_numpy(toks)})[0]

    uniform = {m: fwd(m_active=m) for m in (1, 2)}
    assert torch.equal(fwd(m_schedule=(1, 1)), uniform[1])
    for sched in ((1, 2), (2, 1)):
        got = fwd(m_schedule=sched)
        assert not any(torch.allclose(got, u) for u in uniform.values())
        jq = jc.replace(quant=JQC.replace(m_schedule=sched))
        want, _ = jax.jit(functools.partial(japi.forward, jq))(packed, {"tokens": toks})
        _close(got, want)
        tq = tc.replace(quant=TQC.replace(m_schedule=sched))
        jl, jcache = japi.prefill(jq, packed, toks, max_len=12)
        tl, tcache = tapi.prefill(tq, tpk, torch.from_numpy(toks), max_len=12)
        _close(tl, jl)
        pos, tok = np.array([7], np.int32), np.array([[5]], np.int32)
        jl, jcache = japi.decode_step(jq, packed, {"tokens": tok, "pos": pos, "cache": jcache})
        tl, tcache = tapi.decode_step(tq, tpk, {"tokens": torch.from_numpy(tok),
                                                "pos": torch.from_numpy(pos), "cache": tcache})
        _close(tl, jl)
        _check_cache(tcache, jcache)
    assert not torch.allclose(fwd(m_schedule=(1, 2)), fwd(m_schedule=(2, 1)))


# -------------------------------------------------------------------- Server --

SCENARIOS = {  # name -> (arch, Server kwargs, prompt lengths, m_active per request)
    "bulk": ("deepseek_v3_671b", dict(max_batch=2, prefill="bulk", prefill_buckets=None),
             (6, 3, 9), (None,) * 3),
    "tokenwise": ("deepseek_v3_671b", dict(max_batch=2, prefill="tokenwise"), (6, 3, 9),
                  (None,) * 3),
    "pow2": ("deepseek_v3_671b", dict(max_batch=2), (3, 5, 6, 7, 10), (None,) * 5),
    "mixed_m": ("deepseek_v3_671b", dict(max_batch=3), (4, 7, 5, 9, 6),
                (None, 1, (1, 2), 2, (2, 1))),
    "grok_mixed_m": ("grok_1_314b", dict(max_batch=3), (4, 7, 5, 9), (None, 1, (2, 1), 2)),
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


def test_bulk_matches_tokenwise_at_the_reference_setting(models):
    """The JAX package's own check (``tests/test_serve_prefill.py``,
    ``moe_mla``): reduced DeepSeek-V3 in fp32 with dense linears, a 6-token
    prompt, ``max_batch`` 2, ``max_len`` 32, no buckets, 3 new tokens.  The
    slot's cache rows after admission within 1e-5, the tokens equal and the
    last logits within rtol 2e-5 / atol 5e-5 across the two admissions, and
    each equal to the JAX package's."""
    jc, tc = _cfgs("deepseek_v3_671b", "dense")
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(jp), device="cpu")
    prompt = np.array([3, 7, 11, 2, 9, 4], np.int32)
    results = {}
    for mode in ("bulk", "tokenwise"):
        for mod, cfg, params in ((jserve, jc, jp), (tserve, tc, tp)):
            srv = mod.Server(cfg, params, max_batch=2, max_len=32, prefill=mode,
                             prefill_buckets=None)
            req = mod.Request(prompt=prompt.copy(), max_new_tokens=3)
            assert srv.admit(req)
            rows = [np.array(t[:, 0]) for t in (jax.tree.leaves(srv.cache) if mod is jserve
                                                  else _leaves(srv.cache))]
            srv.run_until_done()
            results[mode, mod.__name__] = (rows, req.out_tokens, req.last_logits)
    port = {m: results[m, tserve.__name__] for m in ("bulk", "tokenwise")}
    for rb, rt in zip(port["bulk"][0], port["tokenwise"][0]):
        np.testing.assert_allclose(rb, rt, rtol=1e-5, atol=1e-5)
    assert port["bulk"][1] == port["tokenwise"][1]
    np.testing.assert_allclose(port["bulk"][2], port["tokenwise"][2], rtol=2e-5, atol=5e-5)
    for m in ("bulk", "tokenwise"):
        ref = results[m, jserve.__name__]
        assert port[m][1] == ref[1]
        np.testing.assert_allclose(port[m][2], ref[2], rtol=2e-5, atol=5e-5)
        for a, b in zip(port[m][0], ref[0]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_server_pads_moe_prompts_to_their_bucket(models):
    """MoE is pad-safe (a positional latent cache), as in the JAX package."""
    jc, tc, _, packed, _, tpk = models["deepseek_v3_671b"]
    ts = tserve.Server(tc, tpk, max_batch=1, max_len=32)
    js = jserve.Server(jc, packed, max_batch=1, max_len=32)
    assert ts._pad_safe and [ts._padded_len(L) for L in range(33)] == \
        [js._padded_len(L) for L in range(33)]


# ------------------------------------------------------------------- convert --

def test_params_from_numpy_carries_a_bf16_deepseek_tree():
    """A bf16 DeepSeek tree (the fp32 router, the [L, E, D, F] expert banks,
    MLA, the dense stack and the MTP head) crosses over bit for bit."""
    jc, _ = _cfgs("deepseek_v3_671b")
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
    assert got["layers"]["moe"]["w_gate"].shape == (1, 4, 64, 64)
    assert got["mtp"]["proj"]["w"].shape == (128, 64)


def test_get_config_resolves_the_moe_family():
    """By module name or by the config's own hyphenated name (the fields are
    held to the reference by ``test_configs_match_the_reference``)."""
    for name in ("deepseek_v3_671b", "deepseek-v3-671b", "grok_1_314b", "grok-1-314b"):
        cfg = tcb.get_config(name)
        assert cfg.family == "moe" and cfg.name.replace("-", "_") == name.replace("-", "_")


def test_moe_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    _, tc = _cfgs("deepseek_v3_671b")
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tapi.init_params(tc, gen),
                 lambda: tapi.init_cache(tc, 1, 8),
                 lambda: ttf.init_layer(gen, tc, kind="moe"),
                 lambda: tmoe.init_moe(gen, tc),
                 lambda: tattn.init_mla(gen, tc),
                 lambda: tattn.init_mla_cache(tc, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
