"""The port's LM training path against the JAX package, on the CPU:
``api.loss_fn`` and its gradients, remat, one ``build_train_step`` step
from the same converted state, microbatching, gradient compression, the
``Trainer`` and the training CLI.  The CNN forwards and the Table II tool
are in ``test_torch_cnn_training.py``.

Weights are drawn by the JAX package and cross over with
``params_from_numpy``; inputs are numpy arrays from seeded generators.
Tolerances (the probes behind them found every difference within 2.2e-6 of
the leaf's largest entry): logits, losses and gradients within rtol 1e-5
with an absolute floor of 1e-5 x the leaf's largest entry (fp32 sums in
another order; an entry near zero keeps the ulps of its terms).  In
``fake_quant`` the gradient is only as close as the W_hat both sides use:
a sign that Algorithm 2 picked otherwise at a tie would fail the tolerance
(none did for these weights), so the same tolerance holds.  The microbatch
check is the JAX package's own (rtol 2e-4 / atol 2e-5,
``tests/test_runtime.py``), resume is bit-exact (``torch.equal``).
"""
import functools
import importlib.util
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import binlinear as jbl
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_numpy
from repro_torch.core import binarize as tbz
from repro_torch.core import binlinear as tbl
from repro_torch.core import compress as tgc
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

jax.config.update("jax_platform_name", "cpu")
ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _close_trees(got_tree, want_tree, rtol=RTOL):
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rtol)


# ---------------------------------------------------------------------- LM loss --

def _lm_cfgs(name, mode, onehot=False, remat=False, K_iters=4):
    kw = dict(dtype="float32", onehot_loss=onehot, remat=remat)
    jc = jcb.reduced(jcb.get_config(name)).replace(
        quant=jbl.QuantConfig(mode=mode, M=2, K_iters=K_iters), **kw)
    tc = tcb.reduced(tcb.get_config(name)).replace(
        quant=tbl.QuantConfig(mode=mode, M=2, K_iters=K_iters), **kw)
    return jc, tc


def _lm_batch(B=2, S=16, vocab=512, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["gemma_2b", "qwen3_14b"])
@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
@pytest.mark.parametrize("onehot,remat", [(False, False), (True, True)])
def test_loss_fn_and_grads_match(name, mode, onehot, remat):
    jc, tc = _lm_cfgs(name, mode, onehot, remat)
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    batch = _lm_batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(functools.partial(japi.loss_fn, jc),
                                              has_aux=True))(jp, batch)
    tg, tm = tsteps.loss_and_grads(functools.partial(tapi.loss_fn, tc),
                                   params_from_numpy(_np(jp), device="cpu"),
                                   _torch_batch(batch))
    _close(tm["loss"], jl)
    _close(tm["ce_loss"], jm["ce_loss"])
    _close_trees(tg, jg)


def test_remat_reruns_algorithm2_in_backward(monkeypatch):
    """With remat each layer's forward runs again in backward, its fake-quant
    binarizations with it (the JAX package's jax.checkpoint does the same);
    the gradients do not change."""
    calls = {"n": 0}
    real = tbz.algorithm2

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tbz, "algorithm2", counted)
    jc, _ = _lm_cfgs("gemma_2b", "fake_quant")
    params = params_from_numpy(_np(japi.init_params(jc, jax.random.PRNGKey(0))), device="cpu")
    batch = _torch_batch(_lm_batch())
    grads, counts = [], []
    for remat in (False, True):
        _, tc = _lm_cfgs("gemma_2b", "fake_quant", remat=remat)
        calls["n"] = 0
        g, _ = tsteps.loss_and_grads(functools.partial(tapi.loss_fn, tc), params, batch)
        grads.append(g)
        counts.append(calls["n"])
    assert counts == [14, 28]            # 2 layers x 7 linears, twice under remat
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- train step --

def _tiny(mode="dense"):
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64, head_dim=8, dtype="float32")
    jc = jcb.reduced(jcb.get_config("gemma_2b")).replace(
        quant=jbl.QuantConfig(mode=mode, M=2, K_iters=4), **kw)
    tc = tcb.reduced(tcb.get_config("gemma_2b")).replace(
        quant=tbl.QuantConfig(mode=mode, M=2, K_iters=4), **kw)
    return jc, tc


@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_train_step_matches_the_reference(mode):
    """One step from the same state, converted from the JAX package's: the
    updated params, and the moments (mu is 0.1 x the clipped grads).  The
    JAX side is its step's body without the mesh: ``jax.value_and_grad`` of
    ``api.loss_fn``, then ``adamw``'s update.  eps is 1e-3: Adam's first step
    moves a param by lr * g / (|g| + eps), so with eps 1e-8 a grad within
    its ulps of 0 would move its update by percents of lr on either side."""
    jc, tc = _tiny(mode)
    jopt = jadamw(1e-2, eps=1e-3)
    jparams = japi.init_params(jc, jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt_state": jopt.init(jparams), "step": jnp.int32(0)}
    tstate = params_from_numpy(_np(jstate), device="cpu")
    assert tstate["step"] == 0            # a 0-d array crosses as a Python int
    batch = {k: np.asarray(v) for k, v in
             SyntheticTokens(64, 16, 4, seed=0, device="cpu").next_batch().items()}

    @jax.jit
    def jstep(state, batch):
        (_, met), g = jax.value_and_grad(functools.partial(japi.loss_fn, jc),
                                         has_aux=True)(state["params"], batch)
        params, opt_state = jopt.update(g, state["opt_state"], state["params"], state["step"])
        return {"params": params, "opt_state": opt_state, "step": state["step"] + 1}, met

    jnew, jmet = jstep(jstate, {k: v.astype(np.int32) for k, v in batch.items()})
    tnew, tmet = tsteps.build_train_step(tc, adamw(1e-2, eps=1e-3))(tstate,
                                                                    _torch_batch(batch))
    assert tnew is tstate and tnew["step"] == 1 and tmet["skipped"] is False
    _close(tmet["loss"], jmet["loss"])
    _close_trees(tnew["opt_state"]["mu"], jnew["opt_state"]["mu"])
    _close_trees(tnew["opt_state"]["nu"], jnew["opt_state"]["nu"])
    _close_trees(tnew["params"], jnew["params"])


def test_compressed_train_step_matches_the_reference():
    """One ``grad_compress_M=2`` step from the same state against the JAX
    package's own ``build_train_step`` on a 1x1 (data, model) mesh.  The
    mesh is ``make_host_mesh``'s shape with Auto axes: jax 0.9's
    ``make_mesh`` makes Explicit ones, under which the step's
    ``with_sharding_constraint`` raises (the JAX package's own
    ``tests/test_runtime.py`` fails there).  The error state is compared
    too; the tolerances are the uncompressed step's."""
    from jax.sharding import AxisType

    from repro.core import compress as jgc
    from repro.launch import steps as jsteps
    from repro.models import common as jcm

    jc, tc = _tiny()
    jopt = jadamw(1e-2, eps=1e-3)
    jparams = japi.init_params(jc, jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt_state": jopt.init(jparams), "step": jnp.int32(0),
              "grad_comp": jgc.init_state(jparams)}
    tstate = params_from_numpy(_np({k: v for k, v in jstate.items() if k != "grad_comp"}),
                               device="cpu")
    tstate["grad_comp"] = tgc.init_state(tstate["params"])
    batch = {k: np.asarray(v) for k, v in
             SyntheticTokens(64, 16, 4, seed=0, device="cpu").next_batch().items()}
    mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    try:
        jstep, _ = jsteps.build_train_step(jc, mesh, jopt, grad_compress_M=2, donate=False)
        with mesh:
            jnew, jmet = jstep(jstate, {k: v.astype(np.int32) for k, v in batch.items()})
    finally:
        jcm.set_axis_rules(None)        # build_train_step installs the mesh's rules
    step = tsteps.build_train_step(tc, adamw(1e-2, eps=1e-3), grad_compress_M=2)
    tnew, tmet = step(tstate, _torch_batch(batch))
    assert tnew["step"] == 1 and tmet["skipped"] is False
    _close(tmet["loss"], jmet["loss"])
    _close_trees(tnew["grad_comp"].error, jnew["grad_comp"].error)
    _close_trees(tnew["opt_state"]["mu"], jnew["opt_state"]["mu"])
    _close_trees(tnew["opt_state"]["nu"], jnew["opt_state"]["nu"])
    _close_trees(tnew["params"], jnew["params"])


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def test_microbatch_matches_full_batch():
    _, tc = _tiny()
    opt = adamw(1e-2)
    state = tsteps.init_train_state(tc, opt, device="cpu")
    batch = SyntheticTokens(tc.vocab, 16, 8, seed=0, device="cpu").next_batch()
    s1, m1 = tsteps.build_train_step(tc, opt)(_clone(state), batch)
    s2, m2 = tsteps.build_train_step(tc, opt, microbatch=4)(_clone(state), batch)
    np.testing.assert_allclose(s1["params"]["embed"]["table"].numpy(),
                               s2["params"]["embed"]["table"].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.build_train_step(tc, opt, microbatch=3)(_clone(state), batch)


def test_compressed_training_converges():
    _, tc = _tiny()
    opt = adamw(1e-2)
    state = tsteps.init_train_state(tc, opt, device="cpu")
    state["grad_comp"] = tgc.init_state(state["params"])
    step_fn = tsteps.build_train_step(tc, opt, grad_compress_M=2)
    data = SyntheticTokens(tc.vocab, 16, 4, seed=0, device="cpu")
    losses = []
    for _ in range(25):
        state, metrics = step_fn(state, data.next_batch())
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state["grad_comp"].error))


# ---------------------------------------------------------------------- Trainer --

def _trainer(tmp_path, total_steps=12, ckpt_every=5):
    _, tc = _tiny()
    opt = adamw(1e-2)
    state = tsteps.init_train_state(tc, opt, device="cpu")
    data = SyntheticTokens(tc.vocab, 16, 4, seed=0, device="cpu")
    tcfg = TrainerConfig(total_steps=total_steps, checkpoint_every=ckpt_every,
                         checkpoint_dir=str(tmp_path), log_every=100)
    return Trainer(tsteps.build_train_step(tc, opt), state, data, tcfg)


def test_trainer_loss_decreases(tmp_path):
    report = _trainer(tmp_path, total_steps=30).run()
    assert report.steps_run == 30 and report.nan_skips == 0
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])


def test_trainer_kill_and_resume_bit_exact(tmp_path):
    full = _trainer(tmp_path / "a", total_steps=10)
    full.run()
    _trainer(tmp_path / "b", total_steps=5).run()
    resumed = _trainer(tmp_path / "b", total_steps=10)
    assert resumed.maybe_resume() and resumed.report.resumed_from == 5
    assert int(resumed.state["step"]) == 5 and resumed.data.state.step == 5
    resumed.run()
    assert resumed.report.steps_run == 5
    for a, b in zip(tree_leaves(full.state), tree_leaves(resumed.state)):
        assert torch.equal(a, b)


def test_trainer_straggler_watchdog_fires(tmp_path):
    trainer = _trainer(tmp_path, total_steps=6, ckpt_every=10)
    orig, calls = trainer.step_fn, {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 4:
            time.sleep(1.0)          # an induced straggler
        return orig(state, batch)

    trainer.step_fn = slow_step
    report = trainer.run()
    assert any(e["step"] == 3 for e in report.straggler_events), report.straggler_events


def test_trainer_nan_guard_skips_the_update(tmp_path, monkeypatch):
    """A non-finite loss on the second step: step_fn leaves params and
    moments as they were (torch.equal), the trainer counts one skip."""
    trainer = _trainer(tmp_path, total_steps=3, ckpt_every=10)
    real, calls = tapi.loss_fn, {"n": 0}

    def nan_on_second(cfg, params, batch):
        loss, metrics = real(cfg, params, batch)
        calls["n"] += 1
        if calls["n"] == 2:
            loss = loss * float("nan")
            metrics = dict(metrics, loss=loss)
        return loss, metrics

    monkeypatch.setattr(tapi, "loss_fn", nan_on_second)
    orig, seen = trainer.step_fn, []

    def watched(state, batch):
        before = _clone(state)
        state, metrics = orig(state, batch)
        seen.append((metrics["skipped"], all(torch.equal(a, b) for a, b in
                                             zip(tree_leaves(before), tree_leaves(state)))))
        return state, metrics

    trainer.step_fn = watched
    report = trainer.run()
    assert report.nan_skips == 1 and report.steps_run == 3 and len(report.losses) == 2
    assert seen == [(False, False), (True, True), (False, False)]
    assert int(trainer.state["step"]) == 2


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "gemma_2b", "--reduced", "--steps", "4", "--checkpoint-every", "2",
            "--checkpoint-dir", str(tmp_path), "--device", "cpu", "--quant-mode",
            "fake_quant", "--grad-compress-M", "2", "--seq", "16", "--batch", "2"]
    ttrain.main(args)
    assert "done: 4 steps" in capsys.readouterr().out
    ttrain.main(args[:4] + ["6"] + args[5:])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "resumed_from=4" in out


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    _, tc = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        tsteps.init_train_state(tc, adamw(1e-3))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "gemma_2b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        _table2_tool().table2(steps=1)


def _table2_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_train_cnn_a", ROOT / "tools" / "torch_train_cnn_a.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


