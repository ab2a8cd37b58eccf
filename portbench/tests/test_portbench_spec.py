"""BENCHMARK.json and the files it names: every cell, configuration,
mix, limit, cost and metric file loads, and the spec keeps the contract's
shape."""

import importlib
import json
import re

import pytest

from portbench import harness
from portbench.cost import shapes

SPEC = json.loads(harness.SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in SPEC["end_to_end"]} == {"throughput", "call_p95_ms", "peak_mem_GiB", "setup_s"}
    assert {m["name"] for m in SPEC["per_layer"]} == {
        "enqueue_ms", "launches", "kernel_ms", "other_device_ms", "roofline", "idle"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] == "throughput"
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace_on", [False, True])
def test_every_cell_loads(cell, trace_on):
    c = harness.load_cell(cell, trace_on)
    assert c.chips == 1
    assert c.limits and all(v > 0 for v in c.limits.values())
    importlib.import_module(f"portbench.loops.{c.mix['loop']}").Loop
    importlib.import_module(f"portbench.cost.{c.mix['loop']}").cost
    for name, _ in c.metrics:
        assert callable(importlib.import_module(f"portbench.metrics.{name}").read)
    assert c.metrics, "every cell reports metrics"


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    config = json.loads((harness.CHECKOUT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert entry["reduced"] == []
    from portbench.reference import dwt

    assert dwt.bank(config["wavelet"], __import__("torch").float64, "cpu")[0].shape[0] == config["taps"]
    assert len(shapes.levels(config["shape"], config["taps"], config["mode"], config["level"])) == config["level"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_each_metric(cell):
    for kind in ("end_to_end", "per_layer"):
        names = {m["name"] for m in SPEC[kind] if "workloads" not in m or cell in m["workloads"]}
        assert len(names) == len(SPEC[kind])
