"""One run of one cell: set-up, the measured window, the traced calls,
the check against the plain reference, and the result.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the configuration's file, ``traffic/<traffic>.json``
(whose ``loop`` names ``loops/<loop>.py`` and ``cost/<loop>.py``),
``limits/<cell>.json`` and ``metrics/<metric>.py`` for each metric the
cell reports.  The harness itself knows no cell.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import common, trace
from .readings import Readings

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
SPEC = CHECKOUT / "BENCHMARK.json"
CSRC = CHECKOUT / "src" / "ptwt_tpu_torch" / "csrc"

#: Calls the traced run profiles after the window (one more is traced
#: first and dropped), and the data index their inputs start at.
PROFILED_CALLS = 3
PROFILE_INDEX = 1 << 40

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "ptwt_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list  # [(name, unit)] this run reports


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, trace_on: bool, spec: dict | None = None) -> Cell:
    spec = spec if spec is not None else json.loads(SPEC.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((CHECKOUT / entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = [(m["name"], m["unit"]) for m in spec[kind] if _applies(m, name)]
    return Cell(name, cell["chips"], config, mix, limits, metrics)


def peak_rates(device) -> dict | None:
    if torch.device(device).type != "cuda":
        return None
    table = json.loads((HERE / "cost" / "peaks.json").read_text())
    return table.get(torch.cuda.get_device_name(device))


def power_limit(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    index = torch.device(device).index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device, t0: float, backend=None):
    """Run ``cell`` and return ``(result, lines)``: the result's object and
    the lines for standard error, the compared numbers last."""
    from . import program

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    loop_name = cell.mix["loop"]
    loops = importlib.import_module(f"portbench.loops.{loop_name}")
    cost = importlib.import_module(f"portbench.cost.{loop_name}")
    backend = backend if backend is not None else program.Program(cell.config, device)
    loop = loops.Loop(cell.config, cell.mix, backend, device, seed)
    setup_start = time.perf_counter()
    loop.setup()
    common.sync(device)
    # what set-up built (torch, the port, the harness, the loop's state)
    # stays; the window's cyclic collections then scan only its own
    gc.collect()
    gc.freeze()
    setup_loop_s = time.perf_counter() - setup_start
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)

    pick = random.Random(seed)
    calls, launches = [], []
    start = time.perf_counter()
    i = 0
    while True:
        index = loop.window_offset + i
        x = loop.make_input(index)
        common.sync(device)
        program.reset_launch_counts()
        s = time.perf_counter()
        loop.call(x)
        returned = time.perf_counter()
        loop.finish()
        done = time.perf_counter()
        calls.append((s, returned, done))
        launches.append({k: v for k, v in program.launch_counts().items() if v})
        if pick.random() * (i + 1) < 1.0:  # a uniform draw over the window's calls
            loop.keep(index)
        loop.drop()
        del x
        i += 1
        if done - start >= seconds:
            break
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else None

    profile = None
    if trace_on:
        inputs = [loop.make_input(PROFILE_INDEX + k) for k in range(PROFILED_CALLS + 1)]
        common.sync(device)
        profile = trace.profile_calls(loop, inputs, trace.program_kernel_names(CSRC))
        del inputs
    loop.release()
    gc.unfreeze()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    check_start = time.perf_counter()
    numbers = loop.check()
    check_s = time.perf_counter() - check_start

    r = Readings(
        on_device=on_cuda, setup_s=start - t0, window_start=start, calls=calls, launches=launches,
        elements_per_call=loop.elements_per_call, peak_bytes=peak,
        cost=cost.cost(cell.config, cell.mix), peak_rates=peak_rates(device), profile=profile,
    )
    metrics = {}
    for name, unit in cell.metrics:
        value = importlib.import_module(f"portbench.metrics.{name}").read(r)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    checks = {}
    for name, limit in cell.limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    dev = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if on_cuda:
        dev["power"] = power_limit(device)
    if profile is not None:
        dev["busy_s"] = profile.busy()
        dev["window_s"] = profile.window[1] - profile.window[0]
    result = {"correct": correct, "attempted": len(calls), "failed": 0, "metrics": metrics, "device": dev}
    if profile is not None:
        result["breakdown"] = trace.breakdown(profile)
    result["readings"] = numbers
    result["checks"] = checks

    split: dict = {}
    for c in launches:
        for k, v in c.items():
            split[k] = split.get(k, 0) + v
    lines = [
        f"cell {cell.name} seed {seed}: {len(calls)} calls in the window, {start - t0!r} s of set-up, "
        f"{check_s!r} s of check; set-up: {setup_start - t0!r} s to the loop (imports, the device), "
        f"{setup_loop_s!r} s in it (seeded data, warm-up, the kernels' build or load)",
        "launches per call by kernel: " + json.dumps({k: v / len(calls) for k, v in sorted(split.items())}),
    ]
    detail = getattr(loop, "detail", None)
    if detail:
        lines.append("program and reference: " + json.dumps(detail))
    lines.append("readings: " + json.dumps(numbers))
    lines += [f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in checks.items()]
    return result, lines
