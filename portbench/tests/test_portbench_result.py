"""The result's line and the run's exits."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ._small import run_small

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_last_line_has_the_contract_shape(trace_on):
    result, lines = run_small("d2.rt", trace_on=trace_on)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"} and isinstance(metric["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    names = set(line["metrics"])
    if trace_on:
        assert names == {"enqueue_ms"}  # the device's metrics need a card
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert names == {"throughput", "call_p95_ms", "setup_s"}  # no peak memory off the card
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"}
    # the compared numbers are the last lines of standard error
    assert [ln.split(":")[0] for ln in lines[-len(line["checks"]):]] == [f"check {n}" for n in line["checks"]]


def _run(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "d2.rt", "--seed", "3", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
    )


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(CHECKOUT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--trace", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
