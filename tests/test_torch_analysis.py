"""The port's static verifier, on the CPU.

``verify_program`` is clean on CNN-A (batch 64) and MobileNetV1-224
(batch 16) as ``compile`` makes them, and flags each Hopper rule of
``repro_torch/analysis/hopper_rules.py`` on a program broken by hand for
that rule.  It reads shapes and fields only, so abstract programs (no
binarization, uninitialised tensors) stand in for compiled ones, and it
never counts its canonical-pick re-runs as plan picks.
"""
import dataclasses

import pytest
import torch

import _torch_programs as tp
from repro_torch import deploy
from repro_torch.analysis import (ProgramVerificationError, assert_verified,
                                  hopper_rules, summarize, verify_program)
from repro_torch.convert import params_from_numpy
from repro_torch.core.binlinear import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models import cnn as tcnn

Q = QuantConfig(mode="binary", M=2)


@pytest.fixture(scope="module")
def nets():
    return {"cnn_a": deploy.abstract_program("cnn_a", Q, (64, 48, 48, 3), device="cpu"),
            "mobilenet": deploy.abstract_program("mobilenet", Q, (16, 224, 224, 3),
                                                 device="cpu")}


def test_compiled_programs_verify_clean(nets):
    program = tp.torch_program("conv_linear", tp.packed_tree("conv_linear"), golden=False)
    picks = ops.plan_pick_count()
    for p in (*nets.values(), program):
        assert verify_program(p) == []
        assert assert_verified(p) == []
    assert ops.plan_pick_count() == picks, "verification counted as plan picks"
    tree = tp.packed_tree("conv_linear")
    assert deploy.compile(params_from_numpy(tree, device="cpu"),
                          tp.specs("conv_linear", tcnn), Q, (4, 8, 8, 3),
                          device="cpu", golden=False, verify=True).golden is None


def _with(program, idx, **fields):
    instrs = list(program.instrs)
    instrs[idx] = dataclasses.replace(instrs[idx], **fields)
    return dataclasses.replace(program, instrs=tuple(instrs))


def _levels(instr, field, n):
    """``field`` with its level axis repeated to ``n`` levels."""
    t = getattr(instr, field)
    return t.repeat(n // t.shape[0] + 1, *([1] * (t.dim() - 1)))[:n].contiguous()


# mobilenet: 0 stem, 1 dw0, 2 pw0, ..., 27 head; cnn_a: 1 is conv2 (18x18, pool 6)
BREAKERS = {
    "shape-chain": ("mobilenet", lambda p: _with(p, 27, K=p.instrs[27].K + 8)),
    "epilogue-pre": ("mobilenet", lambda p: _with(p, 27, pre="bogus")),
    "conv-padding": ("mobilenet", lambda p: _with(p, 0, padding="FULL")),
    "epilogue-pool": ("mobilenet", lambda p: _with(p, 0, pool=3)),
    "pack-width": ("mobilenet", lambda p: _with(
        p, 2, B_tap_packed=p.instrs[2].B_tap_packed[:, :, :-1].contiguous())),
    "alpha-shape": ("mobilenet", lambda p: _with(
        p, 2, alpha=p.instrs[2].alpha[:, :, :-1].contiguous())),
    "levels-mismatch": ("mobilenet", lambda p: _with(p, 1, M=3)),
    "levels-max": ("cnn_a", lambda p: _with(
        p, 1, M=5, B_tap_packed=_levels(p.instrs[1], "B_tap_packed", 5),
        alpha=_levels(p.instrs[1], "alpha", 5))),
    "tensor-layout": ("mobilenet", lambda p: _with(p, 2, alpha=p.instrs[2].alpha.double())),
    "dw-geometry": ("mobilenet", lambda p: _with(p, 1, stride=3)),
    "plan-range": ("mobilenet", lambda p: _with(p, 1, plan=deploy.TilePlan(3, 32))),
    "pool-rows": ("cnn_a", lambda p: _with(p, 1, pool=9, plan=deploy.TilePlan(64, 64))),
    "shared-memory": ("mobilenet", lambda p: _with(p, 2, plan=deploy.TilePlan(512, 128))),
    "plan-noncanonical": ("mobilenet", lambda p: _with(p, 2, plan=deploy.TilePlan(64, 32))),
    "stats-drift": ("mobilenet", lambda p: _with(
        p, 3, stats=dataclasses.replace(p.instrs[3].stats, macs=1))),
}


def test_every_rule_has_a_breaker():
    assert set(BREAKERS) == set(hopper_rules.RULES)


@pytest.mark.parametrize("rule", sorted(BREAKERS))
def test_each_rule_flags_a_hand_broken_program(nets, rule):
    net, breaker = BREAKERS[rule]
    findings = verify_program(breaker(nets[net]))
    fired = {f.rule for f in findings}
    assert rule in fired, (rule, [str(f) for f in findings])
    assert all(f.severity == hopper_rules.RULES[f.rule].severity for f in findings)
    assert [f.severity for f in findings] == sorted(
        (f.severity for f in findings), key=lambda s: s != hopper_rules.ERROR)
    if hopper_rules.RULES[rule].severity == hopper_rules.ERROR:
        with pytest.raises(ProgramVerificationError, match=rule):
            assert_verified(breaker(nets[net]))
    else:
        assert assert_verified(breaker(nets[net]))      # WARN only: returned
    assert summarize(findings)["by_rule"][rule] >= 1


def test_shared_memory_counts_the_direct_path_where_c_is_under_8(nets, monkeypatch):
    """CNN-A's conv1 and conv2 (C = 3, 5) launch the direct path, so their
    frozen GEMM plan's bytes are not what the rule counts (an oversized plan
    trips plan-range alone); a direct tile that does not fit is flagged
    (seeded: the launcher's rule made to stage 64 images per block)."""
    from repro_torch.kernels import binary_conv as bck

    big = _with(nets["cnn_a"], 0, plan=deploy.TilePlan(512, 32))
    assert {f.rule for f in verify_program(big)} == {"plan-range", "plan-noncanonical"}
    pick = bck.direct_plan
    monkeypatch.setattr(bck, "direct_plan", lambda *a: pick(*a) and pick(*a)._replace(ni=64))
    findings = [f for f in verify_program(nets["cnn_a"]) if f.rule == "shared-memory"]
    assert [(f.instr, f.severity) for f in findings] == [("conv1", "ERROR"), ("conv2", "ERROR")]
    assert all("direct path" in f.message for f in findings)
    with pytest.raises(ProgramVerificationError, match="shared-memory"):
        assert_verified(nets["cnn_a"])
    assert verify_program(nets["mobilenet"])[0].instr == "stem"


def test_alignment_of_the_conv_packed_bytes(nets):
    program = nets["mobilenet"]
    tap = program.instrs[2].B_tap_packed
    shifted = torch.empty(tap.numel() + 1, dtype=torch.uint8)[1:].view(tap.shape)
    findings = verify_program(_with(program, 2, B_tap_packed=shifted))
    assert [f.rule for f in findings] == ["tensor-layout"]
    assert "4-byte" in findings[0].message
