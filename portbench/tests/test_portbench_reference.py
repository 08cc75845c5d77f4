"""The plain reference against the port's own plain path on the CPU, and
the control against the limits, at a toy size."""
import pytest
import torch

from portbench import check, network, port, reference
from portbench import weights as wts
from portbench.tests import toy
from repro_torch import deploy

CPU = torch.device("cpu")


def _setup(name, batch=3, seed=2**31 + 5):
    cfg = toy.config(name)
    net = network.layers(cfg)
    w = wts.draw(net, cfg["weights"], cfg["levels"], seed, CPU)
    x = wts.images((batch,) + tuple(cfg["input_hwc"]), seed, 10, CPU)
    return cfg, net, w, x


@pytest.mark.parametrize("m_active", [None, 1])
@pytest.mark.parametrize("name", ["cnn_a", "mobilenet_v1_224"])
def test_reference_matches_the_ports_plain_path(name, m_active):
    cfg, net, w, x = _setup(name)
    program = port.compile_program(cfg, net, w, x.shape[0], CPU)
    got = deploy.execute_reference(program, x, m_active)
    want = reference.forward(net, w, x, network.schedule(net, cfg["levels"], m_active))
    assert got.shape == want.shape == (x.shape[0], cfg["classes"])
    assert check.rel_err(got, want) < 1e-5


@pytest.mark.parametrize("name", ["cnn_a", "mobilenet_v1_224"])
def test_activations_neither_vanish_nor_blow_up(name):
    cfg, net, w, x = _setup(name)
    logits = reference.forward(net, w, x, [cfg["levels"]] * len(net))
    assert torch.isfinite(logits).all()
    assert 1e-2 < float(logits.abs().max()) < 1e3


@pytest.mark.parametrize("workload,name", [
    ("mobilenet_v1_224.offline_b128", "mobilenet_v1_224"),
    ("cnn_a.offline_b1024", "cnn_a")])
def test_control_fails_the_limit_and_the_program_passes_it(workload, name):
    limit = check.limits(workload)["rel_err"]
    for seed in (3, 2**31 + 11, 2**33 + 1):
        cfg, net, w, x = _setup(name, seed=seed)
        sched = [cfg["levels"]] * len(net)
        ref = reference.forward(net, w, x, sched)
        assert check.rel_err(reference.forward(net, w, x, sched, tf32=True), ref) > limit
        program = port.compile_program(cfg, net, w, x.shape[0], CPU)
        assert check.rel_err(port.execute(program, x, None), ref) < limit


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0], dtype=torch.float32)
    assert reference.round_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


def test_weights_follow_the_seed_and_the_stated_scale():
    cfg, net, w, _ = _setup("cnn_a")
    again = wts.draw(net, cfg["weights"], cfg["levels"], 2**31 + 5, CPU)
    other = wts.draw(net, cfg["weights"], cfg["levels"], 2**31 + 6, CPU)
    assert all(torch.equal(w[k]["B"], again[k]["B"]) for k in w)
    assert not torch.equal(w["conv2"]["B"], other["conv2"]["B"])
    conv2 = next(layer for layer in net if layer.name == "conv2")
    a = w["conv2"]["alpha"]
    scale = (cfg["weights"]["alpha_gain"] / (conv2.fan_in * 1.25)) ** 0.5
    assert a.shape == (2, 150) and set(w["conv2"]["B"].unique().tolist()) == {-1, 1}
    assert 0.79 * scale <= float(a[0].min()) and float(a[0].max()) <= 1.21 * scale
    assert torch.allclose(a[1].mean(), 0.5 * a[0].mean(), rtol=0.1)
