"""The port's ``distributed/`` against the JAX package's, on the CPU.

Static parts are held to the JAX package on the abstract programs of
``tests/test_distributed_plan.py`` (CNN-A at (8, 48, 48, 3), MobileNet 0.25
at (8, 32, 32, 3)) and on MobileNetV1-224 at batch 16:

  * ``plan_mesh``'s decisions (kind, d_local, per-device weight bytes per
    instruction; global and local batch, devices) at every listed mesh;
  * every key ``shard_layer_stats`` and ``mesh_totals`` share with the JAX
    functions (``STATS_ONLY`` lists the keys that differ, and why);
  * ``verify_mesh_plan``: each seeded-illegal break of the JAX tests fires
    the same rule in both packages, ``shard-lane`` as ``shard-tile``.

Execution cannot be held to the JAX package here (its sharded executor
needs 8 devices, and its Pallas conv ``pl.Unblocked``), so it is held to
the port's own single-process ``deploy.execute``.  Ranks are spawned by
``distributed.run_local`` on the CPU with gloo: one world of 2 (plans 2x1
and 1x2 on the same group, and the service) and one of 4 (2x2).

  * Data-parallel rows are ``torch.equal`` to ``execute``.
  * A bd layer's channel split is held within rtol 1e-5 and
    atol 1e-4·max|logit|: on the CPU the plain conv's im2col product runs
    MKL's sgemm, whose result for half of N can differ from the whole
    product's columns in the last bits (up to 6.5e-5 at 64x1350->340).  The
    CUDA conv kernel is bit-identical across plans, and ``chip_smoke.py``
    phase 13 holds the bd route ``torch.equal`` on the card.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro import deploy as jdeploy
from repro import distributed as jdist
from repro.analysis import verify_mesh_plan as jverify_mesh_plan
from repro.core.binlinear import QuantConfig as JQuant
from repro.deploy.program import TilePlan as JTilePlan
from repro_torch import deploy
from repro_torch import distributed as tdist
from repro_torch.analysis import verify_mesh_plan
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import binary_conv as bck
from repro_torch.kernels import ops
from repro_torch.models import cnn as tcnn
from repro_torch.serve_cnn import CNNService

jax.config.update("jax_platform_name", "cpu")

JQC = JQuant(mode="binary", M=2, K_iters=4, interpret=True)
QC = QuantConfig(mode="binary", M=2)
NETS = {  # name -> (arch, input shape, abstract_program kwargs)
    "cnn_a": ("cnn_a", (8, 48, 48, 3), {}),
    "mobilenet": ("mobilenet", (8, 32, 32, 3), {"width_mult": 0.25, "n_classes": 10}),
    "mobilenet224": ("mobilenet", (16, 224, 224, 3), {}),
}
MESHES = [(8, 1), (4, 2), (2, 2), (1, 4)]
# keys of one package's stats only: the TPU's working set and HBM estimate
# against the H100 conv block's shared memory; local_plan is in both, as
# (nb, bu, bd) against the port's (rows, cols)
STATS_ONLY = {"jax": {"per_device_vmem_bytes", "per_device_hbm_fused_bytes"},
              "torch": {"per_device_shared_bytes"}}
TOTALS_ONLY = {"jax": {"max_per_device_vmem_bytes"},
               "torch": {"max_per_device_shared_bytes"}}
DIFFERING = {"local_plan"}


@pytest.fixture(scope="module")
def programs():
    """name -> (JAX abstract program, port abstract program)."""
    out = {}
    for name, (arch, shape, kw) in NETS.items():
        jqc = JQC.replace(K_iters=2) if arch == "mobilenet" else JQC
        out[name] = (jdeploy.abstract_program(arch, jqc, shape, **kw),
                     deploy.abstract_program(arch, QC, shape, **kw, device="cpu"))
    return out


PLAN_CASES = ([("cnn_a", *mesh, msb, pw) for mesh in MESHES for msb in (0, None)
               for pw in (True, False)]
              + [("mobilenet", *mesh, msb, pw) for mesh in MESHES for msb in (0, None)
                 for pw in (True, False)]
              + [("mobilenet224", 1, 2, None, True)])


def _plans(programs, net, n_data, n_model, msb=None, pointwise_only=True):
    jprog, tprog = programs[net]
    kw = dict(n_data=n_data, n_model=n_model, pointwise_only=pointwise_only,
              **({} if msb is None else {"min_shard_bytes": msb}))
    return jdist.plan_mesh(jprog, **kw), tdist.plan_mesh(tprog, **kw)


@pytest.mark.parametrize("net,n_data,n_model,msb,pointwise_only", PLAN_CASES)
def test_plan_matches_jax(programs, net, n_data, n_model, msb, pointwise_only):
    picks = ops.plan_pick_count()
    jplan, tplan = _plans(programs, net, n_data, n_model, msb, pointwise_only)
    assert ops.plan_pick_count() == picks, "planning counted as plan picks"
    assert [(s.kind, s.d_local, s.per_device_weight_bytes) for s in tplan.shards] == \
        [(s.kind, s.d_local, s.per_device_weight_bytes) for s in jplan.shards]
    assert (tplan.global_batch, tplan.local_batch, tplan.devices) == \
        (jplan.global_batch, jplan.local_batch, jplan.devices)
    assert verify_mesh_plan(programs[net][1], tplan) == []
    assert len(tplan.describe()) == 1 + len(tplan.shards)
    if net == "mobilenet224":        # the numbers chip_smoke.py phase 13 hard-codes
        tot = tdist.mesh_totals(programs[net][1], tplan)
        assert (tot["sharded_layers"], tot["per_device_weight_bytes"],
                tot["gather_bytes"]) == (9, 741_656, 28_901_376)


@pytest.mark.parametrize("net,n_data,n_model", [
    ("cnn_a", 8, 1), ("cnn_a", 4, 2), ("mobilenet", 8, 1), ("mobilenet", 4, 2),
    ("mobilenet", 2, 2), ("mobilenet", 1, 4), ("mobilenet224", 1, 2),
    ("mobilenet224", 2, 2)])
def test_stats_match_jax(programs, net, n_data, n_model):
    jplan, tplan = _plans(programs, net, n_data, n_model, msb=0)
    jprog, tprog = programs[net]
    jrows, trows = jdist.shard_layer_stats(jprog, jplan), tdist.shard_layer_stats(tprog, tplan)
    assert len(jrows) == len(trows)
    for j, t in zip(jrows, trows):
        assert set(j) - set(t) == STATS_ONLY["jax"] and set(t) - set(j) == STATS_ONLY["torch"]
        shared = (set(j) & set(t)) - DIFFERING
        assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
        if t["shard"] == "bd":
            lp = t["local_plan"]
            assert set(lp) == {"rows", "cols"}
            assert t["per_device_shared_bytes"] == bck.shared_bytes((lp["rows"], lp["cols"]), 2)
    jtot, ttot = jdist.mesh_totals(jprog, jplan), tdist.mesh_totals(tprog, tplan)
    assert set(jtot) - set(ttot) == TOTALS_ONLY["jax"]
    assert set(ttot) - set(jtot) == TOTALS_ONLY["torch"]
    assert {k: ttot[k] for k in set(ttot) & set(jtot)} == \
        {k: jtot[k] for k in set(ttot) & set(jtot)}
    assert ttot["max_per_device_shared_bytes"] > 0


# ---------------------------------------------------------------------------
# verify_mesh_plan: tests/test_distributed_plan.py's seeded-illegal plans
# ---------------------------------------------------------------------------

def _swap(plan, idx, shard):
    shards = list(plan.shards)
    shards[idx] = shard
    return dataclasses.replace(plan, shards=tuple(shards))


def _bd(plan):
    return next(i for i, s in enumerate(plan.shards) if s.kind == "bd")


def _fc(program):
    return next(i for i, ins in enumerate(program.instrs) if ins.kind != "conv")


# name -> (net, rule, break(plan, program, side) -> (bad plan, index or None))
BREAKS = {
    "wrong_arity": ("mobilenet", "shard-plan", lambda p, g, side: (
        dataclasses.replace(p, shards=p.shards[:-1]), None)),
    "bad_axis_size": ("mobilenet", "shard-plan", lambda p, g, side: (
        dataclasses.replace(p, n_data=0), None)),
    "unknown_kind": ("mobilenet", "shard-plan", lambda p, g, side: (
        _swap(p, 0, dataclasses.replace(p.shards[0], kind="columnwise")), 0)),
    "bd_on_non_conv": ("cnn_a", "shard-plan", lambda p, g, side: (
        _swap(p, _fc(g), type(p.shards[0])(
            kind="bd", d_local=8,
            plan=JTilePlan(nb=1, bu=1, bd=128) if side == "jax" else deploy.TilePlan(128, 64))),
        _fc(g))),
    "unfrozen_local_plan": ("mobilenet", "shard-plan", lambda p, g, side: (
        _swap(p, _bd(p), dataclasses.replace(p.shards[_bd(p)], plan=None)), _bd(p))),
    "non_dividing_channels": ("mobilenet", "shard-divisibility", lambda p, g, side: (
        dataclasses.replace(p, n_model=3), None)),
    "wrong_d_local": ("mobilenet", "shard-divisibility", lambda p, g, side: (
        _swap(p, _bd(p), dataclasses.replace(p.shards[_bd(p)],
                                             d_local=p.shards[_bd(p)].d_local + 8)),
        _bd(p))),
    # the JAX package's lane tile bd=24; the port's: a plan outside the conv plan space
    "illegal_tile": ("mobilenet", "shard-tile", lambda p, g, side: (
        _swap(p, _bd(p), dataclasses.replace(
            p.shards[_bd(p)], plan=(dataclasses.replace(p.shards[_bd(p)].plan, bd=24)
                                    if side == "jax" else deploy.TilePlan(100, 24)))),
        _bd(p))),
    "bad_byte_split": ("mobilenet", "shard-accounting", lambda p, g, side: (
        _swap(p, 0, dataclasses.replace(p.shards[0], per_device_weight_bytes=12345)), 0)),
    "ragged_global_batch": ("mobilenet", "shard-batch", lambda p, g, side: (
        dataclasses.replace(p, global_batch=7), None)),
}


def _fired(findings, idx):
    return {("shard-tile" if f.rule == "shard-lane" else f.rule, f.severity)
            for f in findings if idx is None or f.index == idx}


@pytest.mark.parametrize("name", sorted(BREAKS))
def test_seeded_illegal_plan_fires_the_jax_rule(programs, name):
    net, rule, brk = BREAKS[name]
    n_data, n_model = (4, 2)
    jplan, tplan = _plans(programs, net, n_data, n_model, msb=0 if net != "cnn_a" else None)
    jprog, tprog = programs[net]
    jbad, idx = brk(jplan, jprog, "jax")
    tbad, tidx = brk(tplan, tprog, "torch")
    assert idx == tidx
    jf, tf = _fired(jverify_mesh_plan(jprog, jbad), idx), _fired(verify_mesh_plan(tprog, tbad), idx)
    assert rule in {r for r, _ in tf}, (name, tf)
    assert tf == jf, (name, tf, jf)


# ---------------------------------------------------------------------------
# execution: the reduced MobileNet, min_shard_bytes=0, on gloo worlds of 2 and 4
# ---------------------------------------------------------------------------

EXEC = NETS["mobilenet"]


@pytest.fixture(scope="module")
def mobilenet(tmp_path_factory):
    """The reduced MobileNet compiled in this process and saved for the ranks."""
    arch, shape, kw = EXEC
    params = tcnn.init_mobilenet(torch.Generator().manual_seed(2), **kw, device="cpu")
    program = deploy.compile(params, arch, QuantConfig(mode="binary", M=2, K_iters=2),
                             shape, device="cpu", golden=False)
    ckpt = str(tmp_path_factory.mktemp("mesh_prog"))
    deploy.save_program(CheckpointManager(ckpt), 0, program)
    rng = np.random.default_rng(0)
    inputs = {"full": rng.standard_normal(shape).astype(np.float32),
              "ragged": rng.standard_normal((7,) + shape[1:]).astype(np.float32)}
    images = rng.standard_normal((3 * ranks.SERVE_BATCH,) + shape[1:]).astype(np.float32)
    return program, ckpt, inputs, images


@pytest.fixture(scope="module")
def world2(mobilenet):
    program, ckpt, inputs, images = mobilenet
    return tdist.run_local(2, ranks.both, ckpt, EXEC, [(2, 1), (1, 2)], inputs, images,
                           device="cpu")


@pytest.fixture(scope="module")
def world4(mobilenet):
    program, ckpt, inputs, _ = mobilenet
    return tdist.run_local(4, ranks.sharded, ckpt, EXEC, [(2, 2)], inputs, device="cpu")


def _cases(mobilenet, per_rank):
    program, _, inputs, _ = mobilenet
    for key in per_rank[0]:
        n_data, n_model, name, label = key
        want = deploy.execute(program, torch.from_numpy(inputs[name]),
                              ranks.schedules(program)[label]).numpy()
        yield key, want, [r[key] for r in per_rank]


def _check(mobilenet, per_rank):
    program, _, _, _ = mobilenet
    for key, want, got in _cases(mobilenet, per_rank):
        n_data, n_model, _, _ = key
        plan = tdist.plan_mesh(program, n_data=n_data, n_model=n_model, min_shard_bytes=0)
        has_bd = any(s.kind == "bd" for s in plan.shards)
        assert has_bd == (n_model > 1), key
        scale = float(np.abs(want).max())
        assert scale > 0 and np.isfinite(want).all(), key
        for r in got:
            assert r["logits"].shape == want.shape, key
            assert np.array_equal(r["logits"], got[0]["logits"]), f"ranks disagree at {key}"
            assert r["picks"] == 0, f"plan picks in the sharded forward at {key}"
            assert r["bound_grew"] == 0, f"a repeat call bound new slices at {key}"
            if has_bd:
                np.testing.assert_allclose(r["logits"], want, rtol=1e-5, atol=1e-4 * scale,
                                           err_msg=str(key))
            else:
                assert np.array_equal(r["logits"], want), f"data-parallel rows differ at {key}"


def test_world2_data_parallel_and_bd_sharded(mobilenet, world2):
    per_rank = [r["sharded"] for r in world2]
    assert {k[:2] for k in per_rank[0]} == {(2, 1), (1, 2)}
    _check(mobilenet, per_rank)


def test_world4_data_and_model_parallel(mobilenet, world4):
    assert {k[:2] for k in world4[0]} == {(2, 2)}
    _check(mobilenet, world4)


def test_mesh_service_follows_rank0_across_clocks(mobilenet, world2):
    """Rank 1's fake clock moves 1 s a step against a 100 ms target, rank
    0's not at all: rank 1's own controller walks down the ladder, yet both
    ranks serve rank 0's schedule and answer exactly as the plain service
    with rank 0's clock."""
    program, _, _, images = mobilenet
    plain = ranks.serve_requests(program, images, ranks.CLOCK_STEP_S[0])
    assert plain["own_rung"] == 0
    assert world2[1]["serve"]["own_rung"] > 0, "rank 1's clock never moved its controller"
    for r in world2:
        assert np.array_equal(r["serve"]["logits"], plain["logits"])
        assert r["serve"]["schedules"] == plain["schedules"]


def test_one_by_one_plan_runs_in_process(mobilenet):
    program, _, inputs, _ = mobilenet
    plan = tdist.plan_mesh(program, n_data=1)
    for label, m in ranks.schedules(program).items():
        x = torch.from_numpy(inputs["ragged"])
        assert torch.equal(tdist.execute_sharded(program, plan, x, m),
                           deploy.execute(program, x, m)), label


def test_validation_errors(mobilenet, programs):
    program, _, inputs, _ = mobilenet
    x = torch.from_numpy(inputs["full"])
    other = tdist.plan_mesh(programs["cnn_a"][1], n_data=2)
    with pytest.raises(ValueError, match="shard"):
        tdist.execute_sharded(program, other, x)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        tdist.execute_sharded(program, tdist.plan_mesh(program, n_data=2), x)
    with pytest.raises(ValueError, match="input shape"):
        tdist.execute_sharded(program, tdist.plan_mesh(program, n_data=1), x[..., :2])
    with pytest.raises(ValueError, match="mesh axes"):
        tdist.plan_mesh(program, n_data=0)
    with pytest.raises(ValueError, match="global_batch"):
        tdist.plan_mesh(program, n_data=2, global_batch=0)
    # tests/test_distributed_exec.py's service checks
    with pytest.raises(ValueError, match="divide"):
        CNNService(program, batch_size=4, mesh_plan=tdist.plan_mesh(program, n_data=8))
    with pytest.raises(ValueError, match="shard"):
        CNNService(program, batch_size=8, mesh_plan=other)


def test_run_local_defaults_to_the_card(monkeypatch):
    """Without ``device`` the ranks go on the card, so with none
    ``run_local`` raises ``resolve_device``'s error before it spawns."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\) is False"):
        tdist.run_local(2, ranks.sharded)
