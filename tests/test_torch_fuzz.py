"""The port's differential-fuzz generator against the JAX package's, on the CPU.

* ``random_network(seed)`` draws the same :class:`FuzzNet` (specs,
  input shape, execute batch, M) as ``repro.testing.fuzz`` for seeds 0-127,
  the seeds the card's fuzz phase runs.
* The JAX package's pinned seeds (0, 3, 6, 11, ``tests/test_fuzz_programs.py``)
  go through the port's compile -> ``verify_program`` (zero ERRORs) ->
  ``execute`` on the CPU (the kernels' plain versions), held against the
  JAX package's unfused oracle ``cnn.spec_forward`` on the same packed tree
  (JAX ``spec_binarize``, carried across with ``params_from_numpy``) and the
  same numpy input, within rtol 1e-3 / atol 1e-3 as the JAX fuzz test holds
  its own fused path.  Bits are not expected to match across frameworks.
  This container's JAX cannot execute a conv program, so the oracle is the
  reference's jnp path, not its ``deploy.execute``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.binlinear import QuantConfig as JQuant
from repro.models import cnn as jcnn
from repro.testing import fuzz as jfuzz
from repro_torch import deploy
from repro_torch.analysis import verify_program
from repro_torch.convert import params_from_numpy
from repro_torch.core.binlinear import QuantConfig
from repro_torch.models import cnn as tcnn
from repro_torch.testing import fuzz

jax.config.update("jax_platform_name", "cpu")


def _asdicts(specs):
    return [dataclasses.asdict(s) for s in specs]


def test_random_network_draws_the_jax_package_network_for_seeds_0_to_127():
    for seed in range(128):
        mine, ref = fuzz.random_network(seed), jfuzz.random_network(seed)
        assert _asdicts(mine.specs) == _asdicts(ref.specs), seed
        assert (mine.input_shape, mine.exec_batch, mine.M) == (
            ref.input_shape, ref.exec_batch, ref.M), seed


@pytest.mark.parametrize("seed", [0, 3, 6, 11])
def test_pinned_seed_matches_the_jax_oracle(seed):
    net = jfuzz.random_network(seed)
    qc = JQuant(mode="binary", M=net.M, K_iters=2, interpret=True)
    packed = jcnn.spec_binarize(net.specs, net.init_params(jax.random.PRNGKey(seed)), qc)
    tree = jax.tree_util.tree_map(np.asarray, packed)
    x = np.random.default_rng(seed + 99).standard_normal(
        (net.exec_batch,) + net.input_shape[1:], dtype=np.float32)

    specs = fuzz.random_network(seed).specs
    prog = deploy.compile(params_from_numpy(tree, device="cpu"), specs,
                          QuantConfig(mode="binary", M=net.M), net.input_shape,
                          device="cpu", golden=False)
    errors = [f for f in verify_program(prog) if f.severity == "ERROR"]
    assert not errors, (seed, [s.name for s in specs], errors[:3])
    for m in (None, 1):
        got = deploy.execute(prog, torch.from_numpy(x), m).numpy()
        want = np.asarray(jcnn.spec_forward(net.specs, packed, x, qc.replace(m_active=m)))
        n_out = int(specs[-1].name.split("_")[-1])
        assert got.shape == want.shape == (net.exec_batch, n_out)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3,
                                   err_msg=f"seed {seed} m_active {m}")


def test_generator_is_deterministic_and_legal():
    a, b = fuzz.random_network(5), fuzz.random_network(5)
    assert a == b
    for seed in range(8):
        net = fuzz.random_network(seed)
        assert net.specs and net.specs[-1].kind == "linear"
        assert not net.specs[-1].relu            # logits layer
        assert {s.kind for s in net.specs} <= {"conv", "dwconv", "linear"}
        assert 1 <= net.exec_batch <= 5
        assert net.M in (1, 2)


def test_seeds_0_to_127_cover_every_rare_shape():
    seen = {f: [] for f in fuzz.FEATURES}
    for seed in range(128):
        for f in fuzz.features(fuzz.random_network(seed)):
            seen[f].append(seed)
    assert all(seen.values()), seen
    assert seen["pool3"][0] == 66 and 62 in seen["1x1_stride2"], seen
    assert 6 in seen["stride2_pool"], seen


def test_init_params_and_the_per_call_path_on_the_cpu():
    net = fuzz.random_network(11)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            net.init_params(torch.Generator().manual_seed(0))
    params = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    again = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(params[k]["w"], again[k]["w"]) for k in params)
    qc = QuantConfig(mode="binary", M=net.M, K_iters=2)
    packed = tcnn.spec_binarize(net.specs, params, qc)
    prog = deploy.compile(packed, net.specs, qc, net.input_shape, device="cpu",
                          golden=False)
    x = torch.randn((net.exec_batch,) + net.input_shape[1:],
                    generator=torch.Generator().manual_seed(1))
    for m in (None, 1):
        torch.testing.assert_close(fuzz.kernel_forward(net.specs, packed, x, m),
                                   deploy.execute_reference(prog, x, m),
                                   rtol=1e-5, atol=1e-5)
