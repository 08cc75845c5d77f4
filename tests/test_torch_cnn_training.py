"""The port's CNN training path against the JAX package, on the CPU: the
training forwards of CNN-A and MobileNet with their gradients, and the
Table II tool end to end.

Weights are drawn by the JAX package and cross over with
``params_from_numpy``; inputs are numpy arrays from seeded generators.
Tolerances: logits, losses and gradients within rtol 1e-5 with an absolute
floor of 1e-5 x the leaf's largest entry (fp32 sums in another order; the
probes behind it found every difference within 1.4e-6 of the leaf's
largest entry).  In ``fake_quant`` the gradient is only as close as the
W_hat both sides use: for these weights Algorithm 2 chose the same signs on
both sides (the probes counted 0 flipped of 1.3 M in CNN-A and 0.42 M in
MobileNet; a flip would fail the tolerance), so the same tolerance holds.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binlinear as jbl
from repro.models import cnn as jcnn
from repro_torch import deploy
from repro_torch.convert import params_from_numpy
from repro_torch.core import binlinear as tbl
from repro_torch.launch import steps as tsteps
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import tree_leaves

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


# ----------------------------------------------------------------------- CNNs --

def _cnn(arch):
    if arch == "cnn_a":
        params = jcnn.init_cnn_a(jax.random.PRNGKey(0))
        return params, (4, 48, 48, 3), 43, jcnn.cnn_a_forward, tcnn.cnn_a_forward
    params = jcnn.init_mobilenet(jax.random.PRNGKey(0), width_mult=0.25, n_classes=10)
    # depth-wise filters x4 keep the activations of the 27 layers well above 0
    params = {k: dict(v, w=v["w"] * 4) if k.startswith("dw") else v for k, v in params.items()}
    return params, (2, 32, 32, 3), 10, jcnn.mobilenet_forward, tcnn.mobilenet_forward


@pytest.mark.parametrize("arch", ["cnn_a", "mobilenet"])
@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_cnn_logits_and_grads_match(arch, mode):
    """CNN-A (even 4x4 VALID conv, pools 2 and 6) and MobileNet at width 0.25
    and 32² (asymmetric SAME pads of the stride-2 layers, the depth-wise
    path): logits and d loss / d params against jax.grad."""
    jp, shape, classes, jfwd, tfwd = _cnn(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, classes, shape[0])
    K_iters = 25 if arch == "cnn_a" else 8
    jq = jbl.QuantConfig(mode=mode, M=2, K_iters=K_iters)
    tq = tbl.QuantConfig(mode=mode, M=2, K_iters=K_iters)

    def jloss(p, x, y):
        lg = jfwd(p, x, jq)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(lg), y[:, None], 1)), lg

    (jl, jlg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp, x, y)

    def tloss(p, x, y):
        lg = tfwd(p, x, tq)
        nll = -torch.mean(torch.gather(torch.log_softmax(lg, -1), 1, y[:, None]))
        return nll, {"loss": nll, "logits": lg}

    tg, m = tsteps.loss_and_grads(tloss, params_from_numpy(_np(jp), device="cpu"),
                                  torch.from_numpy(x), torch.from_numpy(y))
    _close(m["logits"], jlg)
    _close(m["loss"], jl)
    _close_trees(tg, jg)


def test_cnn_forwards_refuse_packed_trees():
    packed = {"conv1": {"B_tap_packed": torch.zeros(2, 49, 1, 5, dtype=torch.uint8),
                        "alpha": torch.ones(2, 1, 5)}}
    with pytest.raises(ValueError, match="spec_forward"):
        tcnn.cnn_a_forward(packed, torch.zeros(1, 48, 48, 3))
    assert tcnn.cnn_a_macs() == jcnn.cnn_a_macs()


# ------------------------------------------------------------- Table II tool --

def _table2_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_train_cnn_a", ROOT / "tools" / "torch_train_cnn_a.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table2_tool_runs_end_to_end_on_the_cpu():
    """fp32 train -> Algorithm 2 -> STE retrain -> pack -> compile -> execute,
    a few steps at batch 16; execute_reference equals the fake-quant forward
    of the retrained weights within the phase-8a gate (rtol 1e-4 / atol
    1e-4 x max|logit|: per-level sums against x @ W_hat)."""
    out = _table2_tool().table2(steps=6, eval_n=32, batch=16, device="cpu")
    assert len(out["fp_losses"]) == 6 and len(out["rt_losses"]) == 50
    for k in ("acc_fp", "acc_bin", "acc_rt", "acc_deploy"):
        assert 0.0 <= out[k] <= 1.0
    want = out["logits_fake_quant"]
    ref = deploy.execute_reference(out["program"], out["x_eval"])
    scale = float(want.abs().max())
    torch.testing.assert_close(ref, want, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(out["logits_deploy"], want, rtol=1e-4, atol=1e-4 * scale)
    assert abs(out["acc_deploy"] - out["acc_rt"]) <= 0.02
    assert 10 < out["compression"] < 16
