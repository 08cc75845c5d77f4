"""The port's checkpoints: the JAX package's on-disk format both ways, and
every corruption class its manager detects, on the CPU.

* A program the JAX package saved (``golden=False``) loads through the
  port's ``load_program``; a step the port saved restores through the JAX
  package's ``CheckpointManager.restore`` and passes ``tools/fsck_ckpt.py``;
  both packages write the same ``leaves`` for the same program.
* Bit flips name their leaf, tampered manifests, missing payloads, shape
  and dtype mismatches, quarantine, the latest-good walk, crash windows,
  orphan scrubbing and the multi-host merge commit, as in
  ``tests/test_checkpoint_integrity.py`` and
  ``tests/test_checkpoint_multihost.py``.

Tensors are compared bit for bit (``torch.equal`` / ``np.array_equal``).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import _torch_programs as tp
from repro import deploy as jdeploy
from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch import deploy
from repro_torch.checkpoint.manager import (CheckpointCorruption, CheckpointManager,
                                            ChecksumMismatch, LeafMismatch,
                                            ManifestMismatch, NoGoodCheckpoint,
                                            _flatten_with_paths, crc32_hex)
from repro_torch.testing.faults import FaultInjector, FaultPlan

jax.config.update("jax_platform_name", "cpu")


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _tensors(program):
    """``{leaf path: tensor}`` of a program saved as ``{"program": program}``."""
    return _flatten_with_paths({"program": program})[0]


@pytest.fixture(scope="module")
def tree():
    return tp.packed_tree("conv_linear")


@pytest.fixture(scope="module")
def jprogram(tree):
    return tp.jax_program("conv_linear", tree)


@pytest.fixture(scope="module")
def program(tree):
    return tp.torch_program("conv_linear", tree)


# ---------------------------------------------------------------------------
# the JAX package's format, both ways
# ---------------------------------------------------------------------------

def test_jax_saved_program_loads_in_the_port(tmp_path, jprogram, program):
    jdeploy.save_program(JManager(str(tmp_path)), 1, jprogram)
    loaded = deploy.load_program(CheckpointManager(str(tmp_path)), 1, tp.zeroed(program))
    assert loaded.golden is None           # saved with golden=False
    got, want = _tensors(loaded), _tensors(program)
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # the caller records the port's own golden and it replays
    loaded = dataclasses.replace(loaded, golden=deploy.compute_golden(loaded))
    assert deploy.self_test(loaded) == 3


def test_port_saved_step_restores_in_jax_and_passes_fsck(tmp_path, jprogram, program):
    import tools.fsck_ckpt as fsck

    deploy.save_program(CheckpointManager(str(tmp_path)), 1, program)
    restored, extra = JManager(str(tmp_path)).restore(1, {"program": jprogram})
    want = _tensors(program)
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                       for p in path)
        assert np.array_equal(np.asarray(leaf), want[key].numpy()), key
    assert extra["golden_torch"] == program.golden.to_json()
    assert fsck.main([str(tmp_path), "--quiet"]) == 0
    # the JAX package's loader never attaches the port's record
    assert jdeploy.load_program(JManager(str(tmp_path)), 1, jprogram).golden is None


@pytest.mark.parametrize("net", list(tp.NETS))
def test_both_packages_write_the_same_leaves(tmp_path, net):
    tree = tp.packed_tree(net)
    jdeploy.save_program(JManager(str(tmp_path / "jax")), 1, tp.jax_program(net, tree))
    deploy.save_program(CheckpointManager(str(tmp_path / "port")), 1,
                        tp.torch_program(net, tree, golden=False))
    docs = [json.loads((tmp_path / side / "step_0000000001" / "manifest.json").read_text())
            for side in ("jax", "port")]
    assert docs[0]["leaves"] == docs[1]["leaves"]
    assert list(docs[0]["leaves"]) == list(docs[1]["leaves"])       # same order
    npz = [np.load(tmp_path / side / "step_0000000001" / "host_0.npz")
           for side in ("jax", "port")]
    assert npz[0].files == npz[1].files
    for k in npz[0].files:
        assert np.array_equal(npz[0][k], npz[1][k]), k


def test_a_jax_golden_in_the_manifest_is_never_attached(tmp_path, program):
    jax_golden = {"seed": 0, "input_shape": [1, 8, 8, 3], "digests": [[[2, 2], "00000000"]]}
    mgr = CheckpointManager(str(tmp_path))
    deploy.save_program(mgr, 1, dataclasses.replace(program, golden=None),
                        extra={"golden": jax_golden})
    assert deploy.load_program(mgr, 1, tp.zeroed(program)).golden is None


def test_golden_survives_save_and_load(tmp_path, program):
    mgr = CheckpointManager(str(tmp_path))
    deploy.save_program(mgr, 1, program)
    loaded = deploy.load_program(mgr, 1, tp.zeroed(program))
    assert loaded.golden == program.golden and deploy.self_test(loaded) == 3


# ---------------------------------------------------------------------------
# the manager: digests and typed detection
# ---------------------------------------------------------------------------

def test_manifest_records_digests_and_keeps_scalar_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    meta = json.loads((tmp_path / "step_0000000001" / "manifest.json").read_text())
    assert meta["leaves"]["params/w"] == {
        "shape": [3, 4], "dtype": "float32",
        "crc32": crc32_hex(np.arange(12.0, dtype=np.float32).reshape(3, 4).tobytes())}
    assert meta["leaves"]["step"]["shape"] == [] and meta["manifest_crc32"]
    restored, _ = mgr.restore(1, _state())
    assert restored["step"].dim() == 0 and int(restored["step"]) == 3
    assert restored["params"]["w"].device == torch.device("cpu")


def test_disk_bitflip_is_detected_and_named(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    key = FaultInjector(FaultPlan(seed=11)).flip_bit_on_disk(mgr._step_dir(1))
    with pytest.raises(ChecksumMismatch) as e:
        mgr.restore(1, _state())
    assert e.value.leaf == key.replace("__", "/") and e.value.step == 1
    assert e.value.expected != e.value.actual
    assert mgr.verify_step(1) and "digest" in mgr.verify_step(1)[0]


def test_manifest_tamper_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    FaultInjector(FaultPlan()).tamper_manifest(mgr._step_dir(1))
    with pytest.raises(ManifestMismatch):
        mgr.restore(1, _state())


def test_missing_npz_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    FaultInjector(FaultPlan()).remove_npz(mgr._step_dir(1))
    with pytest.raises(CheckpointCorruption, match="npz missing"):
        mgr.restore(1, _state())


def test_shape_and_dtype_mismatches_are_loud(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bad = _state()
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(LeafMismatch, match="shape") as e:
        mgr.restore(1, bad)
    assert e.value.leaf == "params/w"
    bad = _state()
    bad["params"]["b"] = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(LeafMismatch, match="allow_cast"):
        mgr.restore(1, bad)
    restored, _ = mgr.restore(1, bad, allow_cast=True)
    assert restored["params"]["b"].dtype == torch.float64


def test_restore_keeps_the_target_structure(tmp_path, program):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"program": program})
    restored, _ = mgr.restore(1, {"program": tp.zeroed(program)})
    back = restored["program"]
    assert [i.plan for i in back.instrs] == [i.plan for i in program.instrs]
    assert [i.stats for i in back.instrs] == [i.stats for i in program.instrs]
    assert sorted(_tensors(program)) == sorted(
        k.replace("__", "/") for k in np.load(tmp_path / "step_0000000001" / "host_0.npz").files)
    assert "program/instrs/0/B_tap_packed" in _tensors(program)


# ---------------------------------------------------------------------------
# last-known-good walk and quarantine
# ---------------------------------------------------------------------------

def test_latest_good_falls_back_and_quarantines(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    mgr.save(2, _state())
    FaultInjector(FaultPlan(seed=11)).flip_bit_on_disk(mgr._step_dir(2))
    step, restored, _ = mgr.restore_latest_good(_state())
    assert step == 1 and int(restored["step"]) == 3
    assert mgr.all_steps() == [1] and [s for s, _ in mgr.quarantined] == [2]
    (qdir,) = mgr.quarantine_dirs()
    ledger = json.loads((tmp_path / qdir / "quarantine.json").read_text())
    assert ledger["step"] == 2 and "digest" in ledger["reason"]


def test_validate_hook_rejections_quarantine_too(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    mgr.save(2, _state())

    def validate(restored, extra):
        if mgr.latest_step() == 2:
            raise ValueError("rejected by the hook")

    step, _, _ = mgr.restore_latest_good(_state(), validate=validate)
    assert step == 1 and "ValueError" in mgr.quarantined[0][1]


def test_exhausted_walk_and_empty_directory_are_loud(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(NoGoodCheckpoint, match="no checkpoints"):
        mgr.restore_latest_good(_state())
    mgr = CheckpointManager(str(tmp_path / "bad"))
    mgr.save(1, _state())
    FaultInjector(FaultPlan()).remove_npz(mgr._step_dir(1))
    with pytest.raises(NoGoodCheckpoint, match="step 1"):
        mgr.restore_latest_good(_state())


def test_load_latest_good_skips_a_corrupt_program(tmp_path, program):
    mgr = CheckpointManager(str(tmp_path))
    deploy.save_program(mgr, 1, program)
    deploy.save_program(mgr, 2, program)
    # step 3 carries the clean record but a flipped bit: only the self-test sees it
    flipped = FaultInjector(FaultPlan(seed=3)).flip_bit_in_program(program)
    deploy.save_program(mgr, 3, flipped)
    FaultInjector(FaultPlan(seed=3)).flip_bit_on_disk(mgr._step_dir(2))
    step, loaded = deploy.load_latest_good(mgr, tp.zeroed(program))
    assert step == 1 and loaded.golden == program.golden
    reasons = dict(mgr.quarantined)
    assert sorted(reasons) == [2, 3]
    assert "SelfTestFailure" in reasons[3] and "digest" in reasons[2]


# ---------------------------------------------------------------------------
# crash windows and orphans
# ---------------------------------------------------------------------------

def test_commit_crash_rolls_the_displaced_step_back(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())

    def boom(tmp, step_dir):
        raise OSError("simulated crash at commit")

    monkeypatch.setattr(CheckpointManager, "_commit", staticmethod(boom))
    with pytest.raises(OSError, match="simulated crash"):
        mgr.save(1, {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                     "step": torch.tensor(9, dtype=torch.int32)})
    monkeypatch.undo()
    restored, _ = mgr.restore(1, _state())
    assert int(restored["step"]) == 3
    assert [d for d in os.listdir(tmp_path) if d.startswith(".")] == []


def test_hard_crash_between_renames_is_recovered_at_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    os.rename(tmp_path / "step_0000000001", tmp_path / ".displaced_step_0000000001_0")
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.all_steps() == [1]
    assert int(mgr2.restore(1, _state())[0]["step"]) == 3


def test_orphaned_tmp_dirs_are_scrubbed_and_quarantine_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    mgr.save(2, _state())
    os.makedirs(tmp_path / ".tmp_ckpt_dead")
    (tmp_path / ".tmp_ckpt_dead" / "host_0.npz").write_bytes(b"partial")
    mgr2 = CheckpointManager(str(tmp_path))
    assert not (tmp_path / ".tmp_ckpt_dead").exists()
    mgr2.quarantine_step(2, reason="test")
    assert mgr2.all_steps() == [1] and mgr2.latest_step() == 1


# ---------------------------------------------------------------------------
# multi-host merge commit
# ---------------------------------------------------------------------------

def _host_tree(host: int, shared: float = 1.0):
    local = {0: {"w": torch.arange(6.0).reshape(2, 3)}, 1: {"b": torch.arange(3.0)}}[host]
    return {**local, "shared": torch.full((4,), shared)}


def test_multihost_merge_commit_and_digest_audit(tmp_path):
    d = str(tmp_path)
    m0 = CheckpointManager(d, host_id=0, n_hosts=2)
    m1 = CheckpointManager(d, host_id=1, n_hosts=2)
    m0.save(1, _host_tree(0))
    m1.save(1, _host_tree(1))
    files = sorted(os.listdir(tmp_path / "step_0000000001"))
    assert files == ["host_0.npz", "host_1.npz", "manifest_host_0.json",
                     "manifest_host_1.json"]
    assert torch.equal(m1.restore(1, _host_tree(1))[0]["b"], torch.arange(3.0))
    report = m0.cross_host_digests(1)
    assert report["ok"] and report["mismatches"] == []
    m1.save(2, _host_tree(1, shared=2.0))
    m0.save(2, _host_tree(0))
    report = m0.cross_host_digests(2)
    assert not report["ok"] and report["mismatches"][0]["leaf"] == "shared"
