"""On the card: a short run of each cell through ``run.py`` comes out
correct, with every metric of its kind.  Run there with

    python3 -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_short_run_on_the_card(cell, trace_on):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483901", "--seconds", "2",
         "--trace", str(trace_on)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-2000:]
    kind = "per_layer" if trace_on else "end_to_end"
    assert set(line["metrics"]) == {m["name"] for m in SPEC[kind]}
    if trace_on:
        assert 0 < line["metrics"]["roofline"]["value"] <= 100
