"""The port's sharded LM on a mesh of spawned ranks, against the JAX package
and the port's own single-process steps, on the CPU.

Two ``run_local`` spawns on gloo, started together from two threads while
the references run in this process (rank bodies in
``tests/_torch_mesh_lm_ranks.py``, which import no jax; one intra-op
thread per rank):

  * world 4, a 2x2 (data, model) mesh: reduced gemma (fp32, binary M=2,
    one kv head, so the cache's head_dim is split on ``"model"``) through
    ``build_serve_step``'s decode step and prefill forward, with the packed
    tree FSDP and TP-only, against the JAX package's ``api.decode_step`` /
    ``api.forward`` on the same packed bytes (the port's binarization, which
    ``test_torch_lm_models.py`` holds byte-identical to JAX's); every
    binary linear runs the
    kernel wrapper on the rank's rows and column shard, and a failing
    kernel call raises;
  * the same decode step in bf16 at 2x2 (FSDP) against the JAX package's
    in bf16;
  * world 2: the mesh train step (fake-quant M=2) at 2x1 and 1x2 against
    the port's single-process step (which ``test_torch_training.py`` holds
    against JAX); a Trainer's checkpoint at 2x1 restored onto 1x2 with
    ``restore(shardings=)``; a Trainer resuming there; ``pipeline_apply``
    over 2 stages against the JAX ``reference_apply`` on
    ``test_pipeline.py``'s stage function; ``launch/train.py`` started
    with ``WORLD_SIZE`` 2 against the same launcher in one process;
    ``make_production_mesh`` on torch's fake process group (never in the
    pytest process).

Tolerances: logits and cache rtol 1e-4 / atol 1e-4·max|x| (the split
head_dim makes the scores a partial sum over ranks, and MKL's sums change
order when a product's columns or rows are split, so the mesh is not
bit-exact on the CPU); bf16 logits rtol 2e-2 / atol 2e-2·max|logit| (the
two packages round bf16 activations at different points:
``test_torch_lm_encdec.py``'s bf16 tolerance); two fake-quant train steps
(SGD with momentum: ``_torch_mesh_lm_ranks.optimizer`` says why not AdamW)
against single-process: losses rtol 1e-4 and each leaf's update within
1e-4 of its own L2 (the worst leaf read 6.3e-6 here; a bound over the
whole tree's L2 would let a wrong gradient on a small leaf, a norm scale's,
through: 1 % on every norm scale passes 1e-2 over the tree and fails
this).  ``chip_smoke.py`` phase 14c holds gemma-2b's full width to looser
fake-quant bounds, because there they are needed: Algorithm 2 takes each
sign from a residual, a residual within rounding of 0 takes another sign
when alpha is solved over another column count (the mesh solves each
rank's columns), and that moves the weight's W_hat by 2·alpha; it holds a
dense step per leaf instead.  Restore ``torch.equal``; pipeline atol 1e-5
(the JAX test's); the launcher's losses rtol 1e-4.
"""
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_lm_ranks as ranks
from repro.configs import base as jcb
from repro.core import binlinear as jbl
from repro.launch import pipeline as jpipe
from repro.models import api as japi
from repro_torch.configs import base as tcb
from repro_torch.core import binlinear as tbl
from repro_torch.distributed import run_local
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcm
from repro_torch.runtime.trainer import Trainer, TrainerConfig

SLOTS, MAX_LEN, PROMPT = 4, 16, 8
POS = np.array([3, 0, 7, 5], np.int32)


def _rel_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _jax_references(jc, packed, batch, prompt) -> dict:
    jlogits, jcache = jax.jit(functools.partial(japi.decode_step, jc))(packed, batch)
    jprefill, _ = jax.jit(functools.partial(japi.forward, jc))(packed, {"tokens": prompt})
    jc16 = jc.replace(dtype="bfloat16")
    packed16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                            if a.dtype == jnp.float32 and a.ndim < 4 else a, packed)
    jbf16, _ = jax.jit(functools.partial(japi.decode_step, jc16))(
        packed16, jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                               if a.dtype == np.float32 else a, batch))
    return {"decode": np.asarray(jlogits), "cache": jax.tree.map(np.asarray, jcache),
            "prefill": np.asarray(jprefill), "bf16": np.asarray(jbf16.astype(jnp.float32))}


def _np_params(state):
    return tcm.tree_map(lambda t: t.numpy(), state["params"])


def _single_process_training(tc, ckpt_dir) -> dict:
    """The port's single-process references of the train tests: two steps
    from seed 0, and a Trainer's three from seed 1 (``ranks._trainer``'s),
    each with the params it started from; the training launcher's losses."""
    opt = ranks.optimizer()
    state, losses = ranks._train(tc, None)
    trainer = Trainer(tsteps.build_train_step(tc, opt),
                      tsteps.init_train_state(tc, opt, seed=1, device="cpu"), ranks._data(tc),
                      TrainerConfig(total_steps=ranks.TRAIN_STEPS + 1, checkpoint_every=100,
                                    checkpoint_dir=ckpt_dir, log_every=1000))
    report = trainer.run()
    launched = tlaunch.main([*ranks.LAUNCH_ARGS, "--checkpoint-dir",
                             os.path.join(ckpt_dir, "launcher")])
    return {"launcher": launched.losses,
            "steps": (losses, _np_params(state),
                      _np_params(tsteps.init_train_state(tc, opt, device="cpu"))),
            "trainer": (report.losses, _np_params(trainer.state),
                        _np_params(tsteps.init_train_state(tc, opt, seed=1, device="cpu")))}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns at once, each from a thread of its own (world 4 serving
    at 2x2, world 2 training), while the references run here."""
    jqc, tqc = (jbl.QuantConfig(mode="binary", M=2, K_iters=2),
                tbl.QuantConfig(mode="binary", M=2, K_iters=2))
    jc = jcb.reduced(jcb.get_config("gemma_2b")).replace(dtype="float32", quant=jqc)
    tc = tcb.reduced(tcb.get_config("gemma_2b")).replace(dtype="float32", quant=tqc)
    # the port's packed bytes, which the ranks make again from the same seed
    packed = tcm.tree_map(lambda t: jnp.asarray(t.numpy()), ranks.packed_params(tc))
    rng = np.random.default_rng(0)
    cache = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                         japi.cache_specs(jc, SLOTS, MAX_LEN))
    batch = {"tokens": rng.integers(0, jc.vocab, (SLOTS, 1)).astype(np.int32), "pos": POS,
             "cache": cache}
    prompt = rng.integers(0, jc.vocab, (SLOTS, PROMPT)).astype(np.int32)
    tt = tcb.reduced(tcb.get_config("gemma_2b")).replace(
        dtype="float32", quant=tbl.QuantConfig(mode="fake_quant", M=2, K_iters=2))
    rng = np.random.default_rng(1)
    stage = {"w": (rng.standard_normal((2, 16, 16)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal((2, 16)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((24, 16)).astype(np.float32)
    jobs = {"serve": (4, ranks.serve, tc, batch, prompt, 2),
            "train": (2, ranks.train, tt, str(tmp_path_factory.mktemp("mesh_ckpt")), stage, x)}
    out = {}

    def spawn(name, world, fn, *args):
        try:
            out[name] = run_local(world, fn, *args, device="cpu", timeout_s=240)
        except BaseException as e:  # noqa: BLE001 — raised below, in the test's thread
            out[name] = e

    threads = [threading.Thread(target=spawn, args=(name, *job)) for name, job in jobs.items()]
    for t in threads:
        t.start()
    try:
        refs = _jax_references(jc, packed, batch, prompt)
        single = _single_process_training(tt, str(tmp_path_factory.mktemp("trainer_ref")))
    finally:
        for t in threads:
            t.join()
    for r in out.values():
        if isinstance(r, BaseException):
            raise r
    return out, refs, tc, (tt, stage, x), single


@pytest.fixture(scope="module")
def served(spawned):
    """world 4 (2x2): the rank results, the JAX references, the config."""
    out, refs, tc, _, _ = spawned
    return out["serve"], refs, tc


@pytest.mark.parametrize("fsdp", [True, False])
def test_sharded_decode_matches_the_reference(served, fsdp):
    per_rank, want, _ = served
    for r in per_rank:
        got = r[("decode", fsdp)]
        _rel_close(got["logits"], want["decode"])
        for g, w in zip(tcm.tree_leaves(got["cache"]), jax.tree.leaves(want["cache"])):
            _rel_close(g, w)


@pytest.mark.parametrize("fsdp", [True, False])
def test_sharded_prefill_matches_the_reference(served, fsdp):
    per_rank, want, _ = served
    for r in per_rank:
        _rel_close(r[("prefill", fsdp)]["logits"], want["prefill"])


def test_sharded_bf16_decode_matches_the_reference(served):
    per_rank, want, _ = served
    for r in per_rank:
        _rel_close(r["bf16"], want["bf16"], rtol=2e-2)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_binary_linears_run_on_local_column_shards(served, kind):
    """7 linears per layer, each a kernel call on the rank's half of the
    rows (data 2) and half of the columns (model 2), whole along K."""
    per_rank, _, tc = served
    rows = {"decode": (SLOTS // 2, 1), "prefill": (SLOTS // 2, PROMPT)}[kind]
    for r in per_rank:
        for fsdp in (True, False):
            calls = r[(kind, fsdp)]["calls"]
            assert len(calls) == 7 * tc.n_layers
            for x_shape, b_shape in calls:
                assert x_shape[:2] == rows
                M, K8, N_local = b_shape
                assert M == 2 and K8 * 8 >= x_shape[-1]
                assert N_local in {n // 2 for n in (tc.d_model, tc.n_heads * tc.head_dim,
                                                    tc.head_dim, tc.d_ff)}


def test_kernel_failure_raises(served):
    assert all(r["raised"] for r in served[0])


@pytest.fixture(scope="module")
def trained(spawned):
    """world 2: the rank results, the config, the pipeline's inputs and the
    single-process references."""
    out, _, _, (tt, stage, x), single = spawned
    return out["train"], tt, stage, x, single


def _params_close(got, want, init, rtol=1e-4):
    """Each leaf's ``got - init`` within rtol of its own update ``want -
    init``, in L2 (a wrong gradient on a small leaf, such as a norm scale,
    shows here, where the whole tree's L2 would hide it)."""
    for i, (g, w, p) in enumerate(zip(*(tcm.tree_leaves(t) for t in (got, want, init)))):
        err = float(np.linalg.norm(g.astype(np.float64) - w))
        upd = float(np.linalg.norm(w.astype(np.float64) - p))
        assert err <= rtol * upd, (i, w.shape, err, upd)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_train_step_matches_single_process(trained, shape):
    per_rank, _, _, _, single = trained
    losses, params, init = single["steps"]
    for r in per_rank:
        got = r["steps"][shape]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        _params_close(got["params"], params, init)
    # FSDP over data at 2x1, TP over model at 1x2 (a size-1 axis splits nothing)
    want = {(2, 1): "(Shard(dim=1), Replicate())", (1, 2): "(Replicate(), Shard(dim=2))"}
    assert per_rank[0]["steps"][shape]["placements"] == want[shape]


def test_restore_onto_another_mesh_is_equal(trained):
    for r in trained[0]:
        res = r["restore"]
        assert res["equal"] and res["mesh"] == (1, 2) and res["step"] == ranks.TRAIN_STEPS
        assert res["data_state"] is not None


def test_trainer_resumes_onto_the_mesh(trained):
    """One step after resuming at 1x2 from 2x1's checkpoint lands where three
    single-process Trainer steps do."""
    per_rank, _, _, _, single = trained
    losses, params, init = single["trainer"]
    for r in per_rank:
        assert r["resumed_from"] == ranks.TRAIN_STEPS
        np.testing.assert_allclose(r["resume"]["losses"], losses[-1:], rtol=1e-4)
        _params_close(r["resume"]["params"], params, init)


def test_training_launcher_trains_on_the_mesh(trained):
    """``launch/train.py`` started with ``WORLD_SIZE`` 2 trains on
    ``make_host_mesh()``'s 2x1 mesh and lands on the single-process
    launcher's losses; its Trainer's checkpoint is written once, by rank 0,
    and the process group it joined is left to its owner."""
    per_rank, _, _, _, single = trained
    for r in per_rank:
        got = r["launcher"]
        np.testing.assert_allclose(got["losses"], single["launcher"], rtol=1e-4)
        assert got["group_left"] and got["saved"] == [ranks.TRAIN_STEPS]


def test_pipeline_matches_the_reference(trained):
    per_rank, _, stage, x, _ = trained
    want = jpipe.reference_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                                 jax.tree.map(jnp.asarray, stage), jnp.asarray(x))
    for r in per_rank:
        np.testing.assert_allclose(r["pipeline"], np.asarray(want), rtol=0, atol=1e-5)


def test_production_meshes(trained):
    for r in trained[0]:
        assert r["production"] == {False: (("data", "model"), (16, 16)),
                                   True: (("pod", "data", "model"), (2, 16, 16))}
