"""The port's training substrate against the JAX package, on the CPU:
data pipelines, optimizers and schedules, gradient compression, the
fixed-point quantizer, the straight-through estimator, and the checkpoint
forms a train state needs (bfloat16 leaves, NamedTuple nodes).

The same numpy inputs go to both sides.  Tolerances: the data pipelines
equal (np.array_equal); optimizers, the clip, schedules and compression
within rtol 1e-6 (the same fp32 formulas, each op rounded once, fused or
reduced in another order: a few ulps), with an absolute floor of 1e-6 x the
leaf's largest entry where terms cancel (a moment b1·m + (1-b1)·g near 0
keeps the ulps of its terms); the quantizers equal (scaling by a
power of two is exact, both round half to even); an STE's gradient
``torch.equal`` to the upstream one.  ``fake_quant`` against JAX: Algorithm 2
may pick another sign where a residual sits at a tie, so the flipped signs
are counted (at most 1 %) and W_hat is compared on the columns without one
(rtol 1e-5 / atol 1e-6, the alphas' own tolerance in test_torch_binarize).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import binarize as jbz
from repro.core import compress as jgc
from repro.core import quant as jq
from repro.data.images import SyntheticGTSRB as JGTSRB
from repro.data.tokens import SyntheticTokens as JTokens
from repro.optim import optimizers as jopt
from repro.optim import schedule as jsch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import binarize as tbz
from repro_torch.core import compress as tgc
from repro_torch.core import quant as tq
from repro_torch.data.images import SyntheticGTSRB
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models.common import tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedule as tsch

jax.config.update("jax_platform_name", "cpu")
RTOL = 1e-6


def _tree(rng, scale=1.0):
    """A small params-like tree of numpy fp32 leaves (a stacked [L, K, N] one too)."""
    return {"a": {"w": (rng.standard_normal((4, 5)) * scale).astype(np.float32)},
            "b": (rng.standard_normal(7) * scale).astype(np.float32),
            "layers": {"w": (rng.standard_normal((2, 3, 6)) * scale).astype(np.float32)}}


def _torch(tree):
    return {k: _torch(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(np.array(tree, copy=True))


def _close(got_tree, want_tree, rtol=RTOL):
    """Leaf by leaf within ``rtol``, with an absolute floor of ``rtol`` x the
    leaf's largest entry."""
    for g, w in zip(tree_leaves(got_tree), jax.tree.leaves(want_tree)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max())


# --------------------------------------------------------------------- data --

def test_synthetic_gtsrb_matches():
    jds, tds = JGTSRB(seed=0), SyntheticGTSRB(seed=0, device="cpu")
    np.testing.assert_array_equal(tds.templates, jds.templates)
    jx, jy = jds.batch(16, rng=np.random.default_rng(3))
    tx, ty = tds.batch(16, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tx.dtype == torch.float32 and ty.dtype == torch.int64
    jx, jy = jds.eval_set(8)
    tx, ty = tds.eval_set(8)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_synthetic_tokens_match_and_resume(n_hosts, host_id):
    kw = dict(seed=5, host_id=host_id, n_hosts=n_hosts)
    jt, tt = JTokens(512, 70, 4, **kw), SyntheticTokens(512, 70, 4, device="cpu", **kw)
    want = [jt.next_batch() for _ in range(3)]
    got = [tt.next_batch() for _ in range(2)]
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    resumed = SyntheticTokens(512, 70, 4, device="cpu", **kw)
    resumed.load_state_dict(json.loads(json.dumps(tt.state_dict())))
    again = resumed.next_batch()
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(again[k].numpy(), np.asarray(want[2][k]))
    assert resumed.state_dict() == jt.state_dict() == {"seed": 5, "step": 3}


def test_data_pipelines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the pipelines run on it")
    for make in (lambda: SyntheticGTSRB(), lambda: SyntheticTokens(8, 8, 1)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


# ---------------------------------------------------------------- optimizers --

OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(1e-2)),
    "adamw_wd": (lambda m: m.adamw(3e-3, weight_decay=0.01)),
    "adamw_schedule": (lambda m: m.adamw(
        (jsch if m is jopt else tsch).warmup_cosine(1e-2, 2, 5), grad_clip=None)),
    "sgd": (lambda m: m.sgd(1e-2)),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_updates_match(name):
    """Three updates on the same grads (clipped: their norm is above 1):
    params and fp32 moments match the JAX package's within rtol 1e-6."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), [_tree(rng, scale=2.0) for _ in range(3)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _torch(params)
    ts = to.init(tp)
    for i, g in enumerate(grads):
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.int32(i))
        tp2, ts2 = to.update(_torch(g), ts, tp, i)
        assert tp2 is tp and ts2 is ts          # in place
    _close(tp, jp)
    for key in js:
        _close(ts[key], js[key])
        assert all(t.dtype == torch.float32 for t in tree_leaves(ts[key]))


def test_optimizer_updates_bf16_params_through_fp32(monkeypatch):
    """bfloat16 params: fp32 moments, the update rounded once to bf16; a leaf
    cut into pieces (``PIECE``) gets the same bits as one updated whole."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32)).to(torch.bfloat16)
    outs = []
    for piece in (10 ** 9, 80):
        monkeypatch.setattr(topt, "PIECE", piece)
        opt = topt.adamw(1e-2)
        params = {"w": p.clone()}
        state = opt.init(params)
        for i in range(2):
            opt.update({"w": g.clone()}, state, params, i)
        assert params["w"].dtype == torch.bfloat16 and state["mu"]["w"].dtype == torch.float32
        outs.append((params["w"], state["mu"]["w"], state["nu"]["w"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], p)


def test_clip_by_global_norm_matches():
    g = _tree(np.random.default_rng(2), scale=3.0)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = topt.clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tg, jg)
    # below the norm the grads pass unchanged
    small = _tree(np.random.default_rng(3), scale=1e-3)
    tg, _ = topt.clip_by_global_norm(_torch(small), 1.0)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(small)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name,args", [("exponential_decay", (5e-4, 0.9, 7)),
                                       ("cosine_schedule", (1e-3, 12)),
                                       ("warmup_cosine", (3e-4, 5, 16))])
def test_schedules_match(name, args):
    jf, tf = getattr(jsch, name)(*args), getattr(tsch, name)(*args)
    want = [float(jf(jnp.int32(s))) for s in range(20)]
    got = [tf(s) for s in range(20)]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tf(torch.tensor(7, dtype=torch.int32)) == got[7]


# --------------------------------------------------------------- compression --

@pytest.mark.parametrize("M", [1, 2, 3])
def test_compress_grads_matches(M):
    """Two rounds, so the second carries the first's error feedback."""
    rng = np.random.default_rng(M)
    grads = [_tree(rng) for _ in range(2)]
    js = jgc.init_state(jax.tree.map(jnp.asarray, grads[0]))
    ts = tgc.init_state(_torch(grads[0]))
    for g in grads:
        jout, js = jgc.compress_grads(jax.tree.map(jnp.asarray, g), js, M=M)
        tout, ts = tgc.compress_grads(_torch(g), ts, M=M)
        _close(tout, jout)
        _close(ts.error, js.error)
    assert tgc.wire_bytes(_torch(grads[0]), M) == jgc.wire_bytes(
        jax.tree.map(jnp.asarray, grads[0]), M)


# -------------------------------------------------------------- quantization --

@pytest.mark.parametrize("bits,frac", [(8, 4), (8, 2), (6, 3)])
def test_quantize_fixed_matches(bits, frac):
    x = (np.random.default_rng(bits + frac).standard_normal(500) * 6).astype(np.float32)
    x[:4] = [0.03125, -0.09375, 100.0, -100.0]        # ties at frac 4, saturation
    spec_j, spec_t = jq.FixedPointSpec(bits, frac), tq.FixedPointSpec(bits, frac)
    want = np.asarray(jq.quantize_fixed(jnp.asarray(x), spec_j))
    np.testing.assert_array_equal(tq.quantize_fixed(torch.from_numpy(x), spec_t).numpy(), want)
    xt = torch.from_numpy(x).requires_grad_()
    y = tq.fake_quant_activation(xt, spec_t)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jq.fake_quant_activation(jnp.asarray(x), spec_j)))
    up = torch.from_numpy(np.random.default_rng(0).standard_normal(500).astype(np.float32))
    (gx,) = torch.autograd.grad(y, xt, up)
    assert torch.equal(gx, up)                          # the STE is the identity
    assert tq.choose_frac_bits(float(np.abs(x).max()), bits) == jq.choose_frac_bits(
        float(np.abs(x).max()), bits)


def test_quantize_fixed_ste_gradient_is_the_identity():
    x = torch.linspace(-20, 20, 101, requires_grad=True)
    y = tq.quantize_fixed_ste(x, 16.0, -128.0, 127.0)
    up = torch.randn(101, generator=torch.Generator().manual_seed(0))
    (gx,) = torch.autograd.grad(y, x, up)
    assert torch.equal(gx, up)
    want = jq.quantize_fixed_ste(jnp.asarray(x.detach().numpy()), jnp.float32(16.0), -128.0, 127.0)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [None, 1])
def test_int8_pair_matches(axis):
    x = np.random.default_rng(4).standard_normal((5, 9)).astype(np.float32)
    jqv = jq.quantize_int8(jnp.asarray(x), axis=axis)
    tqv = tq.quantize_int8(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(tqv.values.numpy(), np.asarray(jqv.values))
    np.testing.assert_allclose(tqv.scale.numpy(), np.asarray(jqv.scale), rtol=RTOL)
    np.testing.assert_allclose(tq.dequantize_int8(tqv).numpy(),
                               np.asarray(jq.dequantize_int8(jqv)), rtol=RTOL)


# ----------------------------------------------------------------------- STE --

def test_ste_binarize_forward_is_w_hat_and_backward_the_identity():
    gen = torch.Generator().manual_seed(0)
    W = torch.randn(40, 12, generator=gen, requires_grad=True)
    with torch.no_grad():
        W_hat = tbz.reconstruct(tbz.algorithm2(W, 2, K_iters=8))
    y = tbz.ste_binarize(W, W_hat)
    assert torch.equal(y.detach(), W_hat)
    up = torch.randn(40, 12, generator=gen)
    (gw,) = torch.autograd.grad(y, W, up)
    assert torch.equal(gw, up)


@pytest.mark.parametrize("M,group_size,algorithm", [(2, None, 2), (3, 16, 2), (2, None, 1)])
def test_fake_quant_matches_the_reference(M, group_size, algorithm):
    W = np.random.default_rng(11 + M).standard_normal((64, 24)).astype(np.float32)
    kw = dict(algorithm=algorithm, K_iters=8, group_size=group_size)
    want = np.asarray(jbz.fake_quant(jnp.asarray(W), M, **kw))
    Wt = torch.from_numpy(W).requires_grad_()
    got = tbz.fake_quant(Wt, M, **kw)
    # the signs each side chose, and the columns where they agree
    jfn, tfn = (jbz.algorithm2, tbz.algorithm2) if algorithm == 2 else (jbz.algorithm1,
                                                                          tbz.algorithm1)
    akw = {"K_iters": 8} if algorithm == 2 else {}
    jB = np.asarray(jfn(jnp.asarray(W), M, group_size=group_size, **akw).B)
    tB = tfn(torch.from_numpy(W), M, group_size=group_size, **akw).B.numpy()
    flipped = jB != tB
    assert flipped.sum() <= 0.01 * flipped.size, int(flipped.sum())
    same = ~flipped.any(axis=(0, 1))
    assert same.sum() >= 0.9 * same.size
    np.testing.assert_allclose(got.detach().numpy()[:, same], want[:, same],
                               rtol=1e-5, atol=1e-6)
    up = np.random.default_rng(0).standard_normal(W.shape).astype(np.float32)
    jgrad = jax.grad(lambda w: jnp.sum(jbz.fake_quant(w, M, **kw) * up))(jnp.asarray(W))
    (tgrad,) = torch.autograd.grad(got, Wt, torch.from_numpy(up))
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tgrad.numpy(), up)


@pytest.mark.parametrize("N_c,M", [(147, 2), (1350, 3), (9, 1)])
def test_compression_factor_matches(N_c, M):
    assert tbz.compression_factor(N_c, M) == jbz.compression_factor(N_c, M)
    assert tbz.compression_factor(N_c, M, bits_alpha=16, n_bias=0) == \
        jbz.compression_factor(N_c, M, bits_alpha=16, n_bias=0)


# ---------------------------------------------------------------- checkpoint --

def test_checkpoint_bf16_leaves_and_namedtuples_round_trip(tmp_path):
    """A train state with bfloat16 params and a CompressionState node saves
    and restores bit for bit; a bfloat16 leaf is written as the JAX
    package writes it (same npz bytes, same manifest entry)."""
    w = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    bf = torch.from_numpy(w).to(torch.bfloat16)
    state = {"params": {"w": bf}, "step": torch.tensor(3, dtype=torch.int32),
             "grad_comp": tgc.init_state({"w": bf})}
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(3, state)
    like = {"params": {"w": torch.zeros_like(bf)}, "step": torch.tensor(0, dtype=torch.int32),
            "grad_comp": tgc.init_state({"w": bf})}
    got, _ = mgr.restore(3, like)
    assert torch.equal(got["params"]["w"].view(torch.int16), bf.view(torch.int16))
    assert int(got["step"]) == 3 and isinstance(got["grad_comp"], tgc.CompressionState)
    assert torch.equal(got["grad_comp"].error["w"], state["grad_comp"].error["w"])
    jmgr = JManager(str(tmp_path / "jax"))
    jmgr.save(3, {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16)}})
    jleaf = json.loads((tmp_path / "jax" / "step_0000000003" / "manifest.json").read_text())
    tleaf = json.loads((tmp_path / "port" / "step_0000000003" / "manifest.json").read_text())
    assert tleaf["leaves"]["params/w"] == jleaf["leaves"]["params/w"]
