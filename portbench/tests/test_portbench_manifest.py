"""The manifest and the files it names."""
import json

import pytest

from portbench import check, manifest, network, traffic

BENCH = manifest.load()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_meets_the_contract():
    assert manifest.validate(BENCH) == []


def test_validate_finds_breaches():
    bad = json.loads(json.dumps(BENCH))
    bad["end_to_end"][0]["unit"] = "images per second"
    bad["per_layer"][0]["moves"] = "no_such_metric"
    bad["workloads"][0]["traffic"] = "no_such_traffic"
    bad["run_seconds"] = 60
    errors = " ".join(manifest.validate(bad))
    for word in ("unit", "moves", "traffic file missing", "run_seconds"):
        assert word in errors


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_loads_from_its_files(workload):
    cell = manifest.cell(workload)
    net = network.layers(cell.config)
    assert net[-1].out_shape == (cell.config["classes"],)
    assert network.macs_per_image(net) == cell.config["macs_per_image"]
    assert cell.traffic["loop"] in traffic.LOOPS
    assert set(cell.limits) >= {"rel_err"}
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_limit_lies_between_its_readings(workload):
    data = json.loads((check.LIMITS / f"{workload}.json").read_text())
    for name, entry in data["numbers"].items():
        if entry.get("lower") is not None:
            assert entry["lower"] < entry["limit"] < entry["upper"], name


def test_per_layer_metrics_without_workloads_go_where_their_end_to_end_metric_goes():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "x", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "l",
                               "moves": "latency_p95_ms"})
    for w in WORKLOADS:
        per = {m["name"] for m in manifest.cell_metrics(bench, w)[1]}
        assert ("x" in per) == ("serve" in w)
