"""Port parity of the compile-once deployment path, on the CPU.

JAX packed trees are carried across with ``params_from_numpy``, compiled and
executed by ``repro_torch`` on ``device="cpu"`` (where every instruction runs
its kernel's plain PyTorch version), and compared with the reference's
``cnn.spec_forward(..., QuantConfig(mode="binary"))`` under m_active None,
1, a per-layer schedule and a batch other than the compiled one.

* CNN-A at full size: the tree is the reference's own Algorithm 2 packing
  of ``init_cnn_a``.
* MobileNetV1 at width 0.25, 32², 10 classes: ±1 levels drawn with numpy
  and packed by the reference's packers, with alphas scaled to keep the
  activations O(1) through the 28 layers (the reference init shrinks them
  to ~1e-13 there, where an absolute tolerance would check nothing).

Tolerance rtol 1e-4, atol 1e-4·max(1, max|logit|): up to 28 layers of fp32
sums taken in another order on each side.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbz
from repro.core.binlinear import QuantConfig as JQuant
from repro.kernels import binary_conv as jbck
from repro.kernels import binary_dwconv as jbdw
from repro.models import cnn as jcnn
from repro_torch import deploy
from repro_torch.convert import params_from_numpy
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models import cnn as tcnn

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent
M = 2
COMPILED_BATCH = 4
NETS = {  # arch -> (reference specs, input H = W, compiled input shape)
    "cnn_a": (jcnn.CNN_A_SPECS, 48),
    "mobilenet": (jcnn.MOBILENET_SPECS, 32),
}


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1, 1).astype(np.int8)


def _levels_alpha(rng, shape, scale):
    """[M, *shape] alphas: level 0 ~ scale, level 1 ~ 0.4·scale."""
    a0 = scale * (0.8 + 0.4 * rng.random(shape))
    return np.stack([a0 * 0.4 ** m for m in range(M)]).astype(np.float32)


def _scaled_mobilenet_tree(seed=0):
    """A reference-format packed MobileNet (w 0.25, 10 classes) from numpy."""
    rng = np.random.default_rng(seed)
    shapes = jcnn.init_mobilenet(jax.random.PRNGKey(0), width_mult=0.25, n_classes=10)
    tree = {}
    for s in jcnn.MOBILENET_SPECS:
        w = shapes[s.name]["w"].shape
        if s.kind == "conv":
            kh, kw, C, D = w
            B = _signs(rng, (M, kh * kw * C, D))
            pad = np.ones((M, (-B.shape[1]) % 8, D), np.int8)
            tree[s.name] = {
                "B_packed": jbz.pack_bits(jnp.asarray(np.concatenate([B, pad], axis=1))),
                "B_tap_packed": jbck.pack_taps(jnp.asarray(B), kh, kw, C),
                "alpha": _levels_alpha(rng, (1, D), np.sqrt(2.0 / (kh * kw * C))),
                "kh": kh, "kw": kw}
            n_out = D
        elif s.kind == "dwconv":
            kh, kw, _, C = w
            tree[s.name] = {"B_tap_packed": jbdw.pack_dw_taps(jnp.asarray(_signs(rng, (M, 9, C)))),
                            "alpha": _levels_alpha(rng, (C,), np.sqrt(2.0 / 9)),
                            "kh": kh, "kw": kw}
            n_out = C
        else:
            K, N = w
            tree[s.name] = {"B_packed": jbz.pack_bits(jnp.asarray(_signs(rng, (M, K, N)))),
                            "alpha": _levels_alpha(rng, (1, N), np.sqrt(1.0 / K))}
            n_out = N
        tree[s.name]["b"] = (0.05 * rng.standard_normal(n_out)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """Reference packed trees as numpy, one per network."""
    cnn_a = jcnn.spec_binarize(jcnn.CNN_A_SPECS, jcnn.init_cnn_a(jax.random.PRNGKey(0)),
                               JQuant(mode="binary", M=M))
    return {"cnn_a": jax.tree_util.tree_map(np.asarray, cnn_a),
            "mobilenet": _scaled_mobilenet_tree()}


@pytest.fixture(scope="module")
def programs(trees):
    out = {}
    for arch, (_, hw) in NETS.items():
        params = params_from_numpy(trees[arch], device="cpu")
        out[arch] = deploy.compile(params, arch, QuantConfig(mode="binary", M=M),
                                   (COMPILED_BATCH, hw, hw, 3), device="cpu")
    return out


def _reference_forward(specs, tree, x, m_active):
    """``spec_forward`` under a global m_active, or layer by layer under a
    per-layer schedule."""
    q = JQuant(mode="binary")
    if m_active is None or isinstance(m_active, int):
        return jcnn.spec_forward(specs, tree, x, q.replace(m_active=m_active))
    y = x
    for s, m in zip(specs, m_active):
        y = jcnn.spec_forward([s], tree, y, q.replace(m_active=m))
    return y


@pytest.mark.parametrize("arch", list(NETS))
@pytest.mark.parametrize("schedule,batch", [(None, COMPILED_BATCH), (1, COMPILED_BATCH),
                                            ("per_layer", COMPILED_BATCH), (None, 3)])
def test_execute_matches_reference_spec_forward(trees, programs, arch, schedule, batch):
    specs, hw = NETS[arch]
    program = programs[arch]
    m_active = ([1 + i % 2 for i in range(len(specs))] if schedule == "per_layer"
                else schedule)
    x = np.random.default_rng(batch).standard_normal((batch, hw, hw, 3)).astype(np.float32)
    picks = ops.plan_pick_count()
    got = deploy.execute(program, torch.from_numpy(x), m_active).numpy()
    assert ops.plan_pick_count() == picks, "execute picked a tile plan"
    want = np.asarray(_reference_forward(specs, trees[arch], jnp.asarray(x), m_active))
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(want).max() > 1e-2, "logits vanished: the check would be vacuous"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_compile_from_fp_tree_matches_port_spec_forward():
    """compile() binarizes an fp tree; the program equals the plain spec
    walk over the same packing, and compile picks one plan per layer."""
    gen = torch.Generator().manual_seed(0)
    fp = tcnn.init_cnn_a(gen, device="cpu")
    q = QuantConfig(mode="binary", M=M)
    picks = ops.plan_pick_count()
    program = deploy.compile(fp, "cnn_a", q, (2, 48, 48, 3), device="cpu")
    assert ops.plan_pick_count() - picks == len(program) == 5
    x = torch.randn(2, 48, 48, 3, generator=gen)
    packed = tcnn.spec_binarize(tcnn.CNN_A_SPECS, fp, q)
    for m in (None, 1):
        want = tcnn.spec_forward(tcnn.CNN_A_SPECS, packed, x, q.replace(m_active=m))
        assert torch.equal(deploy.execute(program, x, m), want)
        assert torch.equal(deploy.execute_reference(program, x, m), want)


def test_spec_lists_match_reference():
    for ours, theirs in ((tcnn.CNN_A_SPECS, jcnn.CNN_A_SPECS),
                         (tcnn.MOBILENET_SPECS, jcnn.MOBILENET_SPECS)):
        assert [dataclasses.astuple(s) for s in ours] == [dataclasses.astuple(s) for s in theirs]
    assert tcnn.MOBILENET_BLOCKS == jcnn.MOBILENET_BLOCKS


def test_bad_inputs_raise(programs):
    program = programs["cnn_a"]
    with pytest.raises(ValueError, match="does not match program"):
        deploy.execute(program, torch.zeros(2, 47, 48, 3))
    with pytest.raises(ValueError, match="not floating"):
        deploy.execute(program, torch.zeros(2, 48, 48, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="schedule has 2 entries"):
        deploy.execute(program, torch.zeros(2, 48, 48, 3), [1, 2])
    with pytest.raises(ValueError, match="m_active must be >= 1"):
        deploy.execute(program, torch.zeros(2, 48, 48, 3), 0)


def test_entry_points_default_to_the_card_and_raise_without_one(trees):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tcnn.init_cnn_a(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        tcnn.init_mobilenet(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(trees["cnn_a"])
    cpu_tree = params_from_numpy(trees["cnn_a"], device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        deploy.compile(cpu_tree, "cnn_a", QuantConfig(mode="binary"), (1, 48, 48, 3))


def test_port_imports_neither_jax_nor_the_reference():
    # every module of the package, found by walking it (a hand list misses new ones)
    code = ("import importlib, pkgutil, sys, repro_torch; "
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.')]; [importlib.import_module(n) for n in names]; "
            "assert 'repro_torch.distributed.executor' in names, names; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tools = sorted((ROOT / "tools").glob("torch_*.py"))
    assert len(tools) >= 5, tools
    for path in list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py", *tools]:
        text = path.read_text()
        for bad in ("import repro.", "from repro.", "from repro import", "import jax"):
            assert bad not in text, f"{path} contains {bad!r}"
