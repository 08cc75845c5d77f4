"""The metric arithmetic on fixed numbers."""
import math

from portbench import devtrace, harness, manifest, network, roofline
from portbench.tests import toy


def _conv1():
    return network.layers(toy.config("cnn_a"))[0]


def test_conv_layer_macs_and_bytes():
    conv1 = _conv1()
    assert conv1.out_shape == (21, 21, 5)
    assert conv1.macs == 42 * 42 * 5 * 7 * 7 * 3
    nbytes, flops = network.work(conv1, batch=2, m=2)
    x, w, alpha, bias, out = 4 * 2 * 48 * 48 * 3, -(-2 * 147 * 5 // 8), 4 * 2 * 5, 4 * 5, \
        4 * 2 * 21 * 21 * 5
    assert nbytes == x + w + alpha + bias + out == 73180
    assert flops == 2 * 2 * conv1.macs
    assert network.work(conv1, batch=2, m=1)[0] == nbytes - (184 - 92) - 20


def test_same_pads_put_the_extra_element_high():
    assert network.same_pads(224, 3, 2) == (0, 1)
    assert network.same_pads(112, 3, 1) == (1, 1)


def test_rate_counts_calls_that_end_inside_the_window():
    assert harness.rate([100.0, 900.0, 1000.0, 1000.1, 2000.0], batch=8, window_s=1.0) == 24.0


def test_p95_counts_a_missing_answer_as_infinite():
    from portbench import check
    assert check.p95([float(v) for v in range(1, 21)]) == 19.0
    assert check.p95([float(v) for v in range(1, 20)] + [math.inf]) == 19.0
    assert check.p95([float(v) for v in range(1, 19)] + [math.inf] * 2) == math.inf


def _events():
    """A window of 10 µs: two launches of binary_conv (2 + 3 µs), one
    memcpy (1 µs), host spans around them."""
    k = {"ph": "X", "cat": "kernel"}
    h = {"ph": "X", "cat": "user_annotation"}
    return [dict(h, name="portbench.execute", ts=0.0, dur=10.0),
            dict(h, name="aten::zeros", ts=3.5, dur=2.0),
            dict(k, name="void binary_conv_kernel<128, 64>(Args)", ts=1.0, dur=2.0),
            dict(k, name="void binary_conv_kernel<128, 64>(Args)", ts=6.0, dur=3.0),
            dict(k, name="Memcpy HtoD", ts=9.0, dur=1.0, cat="gpu_memcpy")]


def test_device_split_and_idle_share():
    split = devtrace.device_split(_events())
    assert split["window_us"] == 10.0 and split["busy_us"] == 6.0
    assert math.isclose(manifest.reader("device.idle_share.offline")(
        _ctx(split)), 40.0)
    assert devtrace.device_split([e for e in _events() if e["cat"] != "kernel"
                                  and e["cat"] != "gpu_memcpy"]) is None


def _ctx(split, calls=2):
    net = [_conv1()]
    return harness.TraceContext(events=_events(), split=split, net=net, sched=[2],
                                batch=2, calls=calls)


def test_roofline_share_and_mfu():
    ctx = _ctx(devtrace.device_split(_events()))
    nbytes, flops = network.work(ctx.net[0], 2, 2)
    bound = max(flops / 67e12, nbytes / 3.35e12)
    want = 100 * 2 * bound / 5e-6
    assert math.isclose(roofline.share(ctx, "binary_conv_kernel", ("conv",)), want)
    assert manifest.reader("binary_conv_roofline")(ctx) == roofline.share(
        ctx, "binary_conv_kernel", ("conv",))
    assert manifest.reader("binary_dwconv_roofline")(ctx) is None
    assert roofline.share(_ctx(ctx.split, calls=3), "binary_conv_kernel", ("conv",)) is None
    mfu = 100 * 2 * ctx.net[0].macs * 2 * 2 / (10e-6 * 67e12)
    assert math.isclose(manifest.reader("mfu")(ctx), mfu)


def test_serve_split_readers_take_the_mean_per_step():
    ctx = _ctx(None)
    assert manifest.reader("serve.assemble_h2d_ms")(ctx) is None
    ctx.serve_rows = [{"assemble_h2d_ms": 2.0, "execute_ms": 1.0, "screen_d2h_ms": 0.5},
                      {"assemble_h2d_ms": 4.0, "execute_ms": 3.0, "screen_d2h_ms": 1.5}]
    assert manifest.reader("serve.assemble_h2d_ms")(ctx) == 3.0
    assert manifest.reader("executor.execute_ms.serve")(ctx) == 2.0
    assert manifest.reader("serve.screen_d2h_ms")(ctx) == 1.0


def test_breakdown_names_idle_gaps_by_the_host():
    bd = devtrace.breakdown(_events())
    name, seconds = bd["device_ops"][0]
    assert name == "void binary_conv_kernel<128, 64>(Args)" and math.isclose(seconds, 5e-6)
    gaps = dict(bd["idle_gaps"])
    assert math.isclose(gaps["aten::zeros"], 3e-6)
    assert math.isclose(gaps["portbench.execute"], 1e-6)
