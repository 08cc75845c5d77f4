"""The mesh steps' options on spawned CPU ranks (gloo), against the port's
single-process steps on the same params and batches
(``test_torch_training.py`` holds those against the JAX package).

One ``run_local`` spawn of world 2 (rank body in
``tests/_torch_mesh_option_ranks.py``, which imports no jax) builds the 2x1
and 1x2 meshes over its ranks; the references run here while it runs.
Reduced gemma-2b, fp32:

  * binary gradient compression (M=2, SGD with momentum), two steps: each
    leaf's alphas within rtol 1e-5 of single-process; the reconstructed
    gradient elementwise within 1e-5·sum(alpha) (every sign the same),
    except where the single-process residual at some level lies within
    1e-4·alpha of 0, where another summation order may take the other
    sign (those elements are counted, and left out of the next gates);
    the error state and each leaf's update within 1e-3 of that leaf's own
    L2 (a mesh gradient is a reduction in another order: ~1e-7 of it);
  * the microbatched step (``microbatch=2``): each leaf's update within
    1e-4 of its own L2 (``test_torch_mesh_lm.py``'s train gate);
  * the sequence-sharded rules at B = 1 on 2x1: the packed prefill's
    logits within rtol 1e-4 / atol 1e-4·max|logit| of single-process and
    each kernel call on the rank's half of the sequence, its output rows
    ``torch.equal`` to the single-process kernel's rows for the same
    tokens; a dense train step as the microbatched one; a batch that
    divides the data axis (B = 2 at 2x1, B = 1 at 1x2) refused with
    ``ValueError`` (``"data"`` named twice);
  * a compressed single-process Trainer's checkpoint resumed onto 2x1
    with ``Trainer(state_shardings=)``: ``grad_comp`` restored
    ``torch.equal`` onto its params' placements, and the step after it
    at the single-process loss (rtol 1e-4);
  * ``launch/train.py``'s ``main`` with ``WORLD_SIZE`` 2 and
    ``--grad-compress-M 2`` against the same launcher in one process
    (losses rtol 1e-4).
"""
import threading

import numpy as np
import pytest
import torch

import _torch_mesh_option_ranks as ranks
from repro_torch.distributed import run_local
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcm

SHAPES = [(2, 1), (1, 2)]
NEAR = 1e-4                     # |residual| within NEAR·alpha of 0: a sign either way


def _references(ckpt_dir: str) -> dict:
    dense, binary = ranks.config(), ranks.config("binary")
    out = {"compressed": ranks.train(dense, None, n_steps=ranks.COMPRESSED_STEPS,
                                     grad_compress_M=ranks.M),
           "microbatch": ranks.train(dense, None, n_steps=1, microbatch=2),
           "seq_prefill": ranks.prefill(binary, None, seq_sharded=False),
           "seq_train": ranks.train(dense, None, n_steps=1, batch=1, seq=ranks.PROMPT)}
    tr = ranks.compressed_trainer(dense, None, f"{ckpt_dir}/compressed", ranks.RESUME_AT)
    tr.run()
    saved = ranks.numpy_tree(tr.state["grad_comp"].error)
    _, met = tr.step_fn(tr.state, tr.data.next_batch())
    out["resume"] = {"error": saved, "loss": float(met["loss"])}
    out["launcher"] = tlaunch.main([*ranks.LAUNCH_ARGS, "--checkpoint-dir",
                                    f"{ckpt_dir}/launcher_ref"]).losses
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mesh_options"))
    # the compressed Trainer's checkpoint is written before the ranks resume it
    dense = ranks.config()
    ranks.compressed_trainer(dense, None, f"{ckpt}/compressed", ranks.RESUME_AT).run()
    out = {}

    def spawn():
        try:
            out["ranks"] = run_local(2, ranks.options, ckpt, device="cpu", timeout_s=240)
        except BaseException as e:  # noqa: BLE001 — raised below, in the test's thread
            out["ranks"] = e

    t = threading.Thread(target=spawn)
    t.start()
    try:
        refs = _references(str(tmp_path_factory.mktemp("mesh_options_ref")))
    finally:
        t.join()
    if isinstance(out["ranks"], BaseException):
        raise out["ranks"]
    return out["ranks"], refs


def _leaf_l2_close(got, want, base, rtol, keep=None):
    """Each leaf's ``got - want`` within rtol of ``want - base`` in L2 (over
    the elements ``keep`` marks, where given)."""
    leaves = [tcm.tree_leaves(t) for t in (got, want, base)]
    for i, (g, w, b) in enumerate(zip(*leaves)):
        k = np.ones(w.shape, bool) if keep is None else keep[i]
        err = float(np.linalg.norm((g.astype(np.float64) - w)[k]))
        own = float(np.linalg.norm((w.astype(np.float64) - b)[k]))
        assert err <= rtol * own, (i, w.shape, err, own)


def _near_zero(rec) -> np.ndarray:
    """Where the single-process residual at some level lies within
    NEAR·alpha of 0 (``core/compress.py``'s levels, replayed)."""
    r, near = rec["target"].astype(np.float32), np.zeros(rec["target"].shape, bool)
    for a in rec["alphas"]:
        near |= np.abs(r) <= NEAR * a
        r = r - a * np.where(r >= 0, 1.0, -1.0).astype(np.float32)
    return near


@pytest.mark.parametrize("shape", SHAPES)
def test_compressed_mesh_step_matches_single_process(spawned, shape):
    per_rank, refs = spawned
    want = refs["compressed"]
    n_leaves = len(tcm.tree_leaves(want["params"]))
    assert len(want["records"]) == ranks.COMPRESSED_STEPS * n_leaves
    # a leaf's elements flagged at this step or an earlier one (a sign taken
    # otherwise moves the error that the next step feeds back)
    near = [_near_zero(rec) for rec in want["records"]]
    for i in range(n_leaves, len(near)):
        near[i] = near[i] | near[i - n_leaves]
    # records come in the tree's insertion order, tree_leaves in sorted order
    order = iter(range(n_leaves))
    sorted_idx = tcm.tree_leaves(tcm.tree_map(lambda _: next(order), want["params"]))
    for r in per_rank:
        got = r[shape]["compressed"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        assert len(got["records"]) == len(want["records"])
        for g, w, n in zip(got["records"], want["records"], near):
            np.testing.assert_allclose(g["alphas"], w["alphas"], rtol=1e-5)
            # the same signs: within 1e-5·sum(alpha) (a sign taken otherwise
            # moves an element by 2·alpha; where b_1 = -b_2 the element is
            # alpha_1 - alpha_2, which a relative bound cannot hold)
            np.testing.assert_allclose(g["recon"][~n], w["recon"][~n], rtol=0,
                                       atol=1e-5 * float(w["alphas"].sum()))
        keep = [~near[len(near) - n_leaves + i] for i in sorted_idx]
        print(f"{shape}: {sum(int((~k).sum()) for k in keep)} of "
              f"{sum(k.size for k in keep)} elements near a sign change")
        _leaf_l2_close(got["error"], want["error"], tcm.tree_map(np.zeros_like, want["error"]),
                       1e-3, keep=keep)
        _leaf_l2_close(got["params"], want["params"], want["init"], 1e-3, keep=keep)
    # the error state sits on its params' placements: FSDP at 2x1, TP at 1x2
    placed = per_rank[0][shape]["compressed"]["error_placements"]
    assert {(2, 1): "(Shard(dim=1), Replicate())",
            (1, 2): "(Replicate(), Shard(dim=2))"}[shape] in placed


@pytest.mark.parametrize("shape", SHAPES)
def test_microbatched_mesh_step_matches_single_process(spawned, shape):
    per_rank, refs = spawned
    want = refs["microbatch"]
    for r in per_rank:
        got = r[shape]["microbatch"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        _leaf_l2_close(got["params"], want["params"], want["init"], 1e-4)


def test_sequence_sharded_prefill_runs_on_local_rows(spawned):
    """At 2x1 each rank's kernel calls take its half of the sequence."""
    per_rank, refs = spawned
    want = refs["seq_prefill"]
    rows = ranks.PROMPT // 2
    scale = float(np.abs(want["logits"]).max())
    for rank, r in enumerate(per_rank):
        got = r["seq_prefill"]
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-4 * scale)
        assert len(got["calls"]) == len(want["calls"]) == 7 * ranks.config().n_layers
        for (x_shape, y), (_, y_whole) in zip(got["calls"], want["calls"]):
            assert x_shape[:2] == (1, rows)
            assert torch.equal(torch.from_numpy(y), torch.from_numpy(
                y_whole[:, rank * rows:(rank + 1) * rows]))


def test_sequence_sharded_train_step_matches_single_process(spawned):
    per_rank, refs = spawned
    want = refs["seq_train"]
    for r in per_rank:
        got = r["seq_train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        _leaf_l2_close(got["params"], want["params"], want["init"], 1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_sequence_sharding_refuses_a_dividing_batch(spawned, shape):
    """B = 2 on a data axis of 2, and B = 1 on a data axis of 1 (which
    divides every batch): the batch and the sequence both on ``"data"``,
    which JAX's constraint refuses too."""
    for r in spawned[0]:
        assert "splits two dims" in r["refused"][shape]


def test_compressed_trainer_resumes_onto_the_mesh(spawned):
    per_rank, refs = spawned
    want = refs["resume"]
    for r in per_rank:
        got = r["resume"]
        assert got["resumed_from"] == ranks.RESUME_AT and got["placed"]
        assert got["step"] == ranks.RESUME_AT + 1
        for g, w in zip(tcm.tree_leaves(got["error"]), tcm.tree_leaves(want["error"])):
            assert torch.equal(torch.from_numpy(g), torch.from_numpy(w))
        np.testing.assert_allclose(got["losses"], [want["loss"]], rtol=1e-4)


def test_compressed_launcher_trains_on_the_mesh(spawned):
    per_rank, refs = spawned
    for r in per_rank:
        np.testing.assert_allclose(r["launcher"], refs["launcher"], rtol=1e-4)
