"""The port's golden self-test and degradation ladder, on the CPU.

* ``golden_rungs``, ``default_ladder`` and ``schedule_cost`` equal the JAX
  package's on the same programs (two small custom ones, CNN-A, and
  MobileNetV1 at width 1.0 / 224² as abstract programs).
* ``GoldenRecord`` round-trips through JSON, and the JAX package's
  ``from_json`` reads the port's fields.
* ``self_test`` passes on a clean program and catches a flipped bit at
  every rung; a record made on another device type is a ``ValueError``,
  not a ``SelfTestFailure``.

Digests are the port's own (bit-exact CRC32 of its outputs), so nothing
here compares them with the JAX package's.
"""
import dataclasses

import jax
import pytest
import torch

import _torch_programs as tp
from repro import deploy as jdeploy
from repro.core.binlinear import QuantConfig as JQuant
from repro.deploy.program import GoldenRecord as JGoldenRecord
from repro.serve_cnn import slo as jslo
from repro_torch import deploy
from repro_torch.core.binlinear import QuantConfig
from repro_torch.serve_cnn import slo
from repro_torch.testing.faults import FaultInjector, FaultPlan

jax.config.update("jax_platform_name", "cpu")

BIG = {"cnn_a": (4, 48, 48, 3), "mobilenet": (16, 224, 224, 3)}


@pytest.fixture(scope="module")
def program():
    return tp.torch_program("conv_linear", tp.packed_tree("conv_linear"))


def _pair(name):
    """(JAX program, port program) of the same network."""
    if name in tp.NETS:
        tree = tp.packed_tree(name)
        return tp.jax_program(name, tree), tp.torch_program(name, tree, golden=False)
    q = dict(mode="binary", M=2)
    return (jdeploy.abstract_program(name, JQuant(**q), BIG[name]),
            deploy.abstract_program(name, QuantConfig(**q), BIG[name], device="cpu"))


@pytest.mark.parametrize("name", list(tp.NETS) + list(BIG))
def test_rungs_ladder_and_cost_equal_the_reference(name):
    jprog, prog = _pair(name)
    assert deploy.golden_rungs(prog) == jdeploy.golden_rungs(jprog)
    ladder = slo.default_ladder(prog)
    assert ladder == jslo.default_ladder(jprog)
    assert len(ladder) == 3 and ladder[0] == prog.resolve_schedule(None)
    for sched in ladder + (None, 1):
        assert slo.schedule_cost(prog, sched) == jslo.schedule_cost(jprog, sched)
    assert prog.totals()["macs"] == jprog.totals()["macs"]
    assert prog.totals()["weight_bytes"] == jprog.totals()["weight_bytes"]
    for ours, theirs in zip(prog.layer_stats(), jprog.layer_stats()):
        for key in ("name", "kind", "pre", "relu", "M", "in_shape", "out_shape", "macs",
                    "weight_bytes"):
            assert ours[key] == theirs[key], (name, key)


def test_compile_records_golden_at_every_rung(program):
    rec = program.golden
    assert rec.device == "cpu" and rec.seed == 0 and rec.input_shape == (1, 8, 8, 3)
    assert rec.schedules() == deploy.golden_rungs(program)
    assert all(len(d) == 8 and int(d, 16) >= 0 for _, d in rec.digests)


def test_golden_json_round_trip_and_reference_reader(program):
    doc = program.golden.to_json()
    assert deploy.GoldenRecord.from_json(doc) == program.golden
    theirs = JGoldenRecord.from_json(doc)
    assert (theirs.seed, theirs.input_shape, theirs.digests) == (
        program.golden.seed, program.golden.input_shape, program.golden.digests)


def test_golden_off_and_seeded(program):
    tree = tp.packed_tree("conv_linear")
    assert tp.torch_program("conv_linear", tree, golden=False).golden is None
    seeded = tp.torch_program("conv_linear", tree, golden=5)
    assert seeded.golden.seed == 5 and seeded.golden.digests != program.golden.digests
    assert deploy.self_test(seeded) == 3


def test_self_test_passes_clean_and_measures_the_clean_executor(program):
    from repro_torch.testing.faults import inject_faults

    assert deploy.self_test(program) == 3
    with inject_faults(FaultPlan(error_rate=1.0, nan_rate=1.0)) as inj:
        assert deploy.self_test(program) == 3
    assert inj.counts["calls"] == 0


@pytest.mark.parametrize("rung", [0, 1, 2])
@pytest.mark.parametrize("instr", [0, 1])
def test_self_test_catches_a_flipped_bit_at_every_rung(program, rung, instr):
    bad = FaultInjector(FaultPlan(seed=rung)).flip_bit_in_program(program, instr=instr)
    sched = program.golden.schedules()[rung]
    with pytest.raises(deploy.SelfTestFailure) as e:
        deploy.self_test(bad, rungs=[sched])
    assert e.value.rung == sched and e.value.expected != e.value.actual
    # the flip changed a copy, never the program it came from
    assert deploy.self_test(program, rungs=[sched]) == 1


def test_a_record_from_another_device_type_is_a_value_error(program):
    foreign = dataclasses.replace(program, golden=dataclasses.replace(program.golden,
                                                                      device="cuda"))
    with pytest.raises(ValueError, match="made on 'cuda'"):
        deploy.self_test(foreign)
    with pytest.raises(ValueError, match="no GoldenRecord"):
        deploy.self_test(dataclasses.replace(program, golden=None))
    with pytest.raises(ValueError, match="no recorded golden digest"):
        deploy.self_test(program, rungs=[(2, 1)])


def test_golden_probe_is_seeded_on_the_cpu_generator():
    a = deploy.selftest.golden_input(3, (1, 4, 4, 3), "cpu")
    b = torch.randn((1, 4, 4, 3), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert deploy.selftest.output_digest(a) == deploy.selftest.output_digest(b.clone())
