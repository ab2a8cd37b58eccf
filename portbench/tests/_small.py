"""Cells of BENCHMARK.json at a size a CPU test holds: the same
configuration and mix with fewer and smaller items."""

from __future__ import annotations

import json
import time

import torch

from portbench import harness

#: Every mix on each configuration: the cells of BENCHMARK.json and the
#: ones PERF.md keeps for later (their traffic and limits files are here).
SPEC = json.loads(harness.SPEC.read_text())
for _name, _config, _traffic in (("d1.rt", "d1_db5_L10_periodic", "rt"),
                                 ("d2.train", "d2_db5_L5_periodic", "train")):
    if all(w["name"] != _name for w in SPEC["workloads"]):
        SPEC["workloads"].append({"name": _name, "config": _config, "traffic": _traffic, "chips": 1})
CELLS = ("d2.rt", "d1.rt", "d2.train", "d1.learn")
SHAPES = {2: [64, 60], 1: [5001]}


def small_cell(name: str, trace_on: bool = False) -> harness.Cell:
    cell = harness.load_cell(name, trace_on, SPEC)
    ndim = len(cell.config["shape"])
    cell.config["shape"] = SHAPES[ndim]
    cell.config["level"] = min(cell.config["level"], 3 if ndim == 2 else 5)
    cell.mix["batch"] = 4
    cell.mix["reference_block"] = 3
    return cell


def run_small(name: str, backend=None, seed: int = 2**31 + 5, trace_on: bool = False, cell=None):
    cell = cell or small_cell(name, trace_on)
    torch.set_num_threads(1)
    return harness.run(cell, seed, 0.3, trace_on, "cpu", time.perf_counter(), backend=backend)
