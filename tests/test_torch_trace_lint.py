"""The port's trace lint (``repro_torch.analysis.trace_lint``), on the CPU.

Each rule fires on a call built to break it, as the JAX package's
``tests/test_analysis.py`` lints its reference kernels: the plain
depth-wise version (``F.conv2d``) fires ``trace-fp-conv``, a plan pick
inside the call fires ``trace-plan-pick`` (and the counter is restored),
a float64 cast fires ``trace-f64``, and a call that picks or launches
other than one kernel per instruction fires ``trace-retrace``.  On the CPU
``execute`` runs the plain versions, so ``lint_execute`` fires
``trace-fp-conv`` there and nothing else; the clean result is the card's
(``tests/test_torch_cuda.py``, phase 9 of ``chip_smoke.py``).  The rule ids
and severities are the JAX package's.
"""
import pytest
import torch

from repro.analysis import mosaic_rules
from repro_torch import deploy
from repro_torch.analysis import hopper_rules, trace_lint
from repro_torch.core.binlinear import QuantConfig
from repro_torch.deploy import executor
from repro_torch.kernels import binary_matmul as bmk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

Q = QuantConfig(mode="binary", M=2)


@pytest.fixture(scope="module")
def mobilenet():
    return deploy.abstract_program("mobilenet", Q, (2, 32, 32, 3), width_mult=0.25,
                                   n_classes=10, device="cpu")


def _rules(findings):
    return sorted(f.rule for f in findings)


def test_rule_ids_and_severities_are_the_jax_packages():
    jax_trace = {k: r.severity for k, r in mosaic_rules.RULES.items()
                 if k.startswith("trace-")}
    assert {k: r.severity for k, r in hopper_rules.TRACE_RULES.items()} == jax_trace
    assert not set(hopper_rules.TRACE_RULES) & set(hopper_rules.RULES)


def test_plain_depthwise_fires_trace_fp_conv(mobilenet):
    dw = next(i for i in mobilenet.instrs if i.kind == "dwconv")
    x = torch.randn((2,) + tuple(dw.stats.in_shape[1:]))
    findings = trace_lint.lint_fn(
        lambda xx: kref.binary_dwconv_relu_ref(
            xx, dw.B_tap_packed, dw.alpha, bias=dw.bias, kh=dw.kh, kw=dw.kw,
            stride=dw.stride, padding="SAME"), (x,), label="ref-dw")
    assert _rules(findings) == ["trace-fp-conv"]
    assert "convolution" in findings[0].message


def test_plan_pick_fires_and_the_counter_is_restored():
    before = ops.plan_pick_count()
    findings = trace_lint.lint_fn(lambda x: (ops.pick_conv_plan(64, 32, 2), x + 1)[1],
                                  (torch.zeros(3),), label="pick")
    assert _rules(findings) == ["trace-plan-pick"]
    assert ops.plan_pick_count() == before


def test_float64_fires_trace_f64():
    findings = trace_lint.lint_fn(lambda x: x.double() * 2, (torch.zeros(3),),
                                  full_binary=False, label="f64")
    assert _rules(findings) == ["trace-f64"]
    assert findings[0].severity == "ERROR" and "float64" in findings[0].message


def test_execute_on_the_cpu_runs_library_ops_and_nothing_else(mobilenet):
    before = ops.plan_pick_count()
    for m in (None, 1, [1 + i % 2 for i in range(len(mobilenet))]):
        findings = trace_lint.lint_execute(mobilenet, m_active=m)
        assert _rules(findings) == ["trace-fp-conv"], [str(f) for f in findings]
        assert "bmm" in findings[0].message and "convolution" in findings[0].message
    assert ops.plan_pick_count() == before
    seen, n64, picks = trace_lint.record_ops(
        lambda x: deploy.execute(mobilenet, x), (torch.zeros(1, 32, 32, 3),))
    assert seen["convolution"] == 13 and n64 == 0 and picks == 0


def test_retrace_is_clean_for_repeated_traffic(mobilenet):
    x = torch.zeros(2, 32, 32, 3)
    assert trace_lint.retrace_findings(mobilenet, x, schedules=(None, 1), repeats=3) == []


def test_retrace_fires_on_a_pick_or_a_stray_launch(mobilenet, monkeypatch):
    x = torch.zeros(2, 32, 32, 3)
    apply = executor._apply
    monkeypatch.setattr(ops, "_plan_picks", ops.plan_pick_count())   # restored after
    monkeypatch.setattr(bmk, "launches", bmk.launches)

    def picking(instr, y, m):
        ops.pick_matmul_plan(y.shape[0], 8)
        return apply(instr, y, m)

    monkeypatch.setattr(executor, "_apply", picking)
    findings = trace_lint.retrace_findings(mobilenet, x, schedules=(None,), repeats=2)
    assert _rules(findings) == ["trace-retrace"] and "plan pick" in findings[0].message

    def launching(instr, y, m):
        bmk.launches += 1
        return apply(instr, y, m)

    monkeypatch.setattr(executor, "_apply", launching)
    findings = trace_lint.retrace_findings(mobilenet, x, schedules=(None,), repeats=2)
    assert _rules(findings) == ["trace-retrace"] and "launches" in findings[0].message
