"""Readings for the limits of ``correct``: many seeds of a cell in one
process, the program or the control in its place.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 [--control]

Each seed runs as a run of ``run.py`` does (set-up, a window of
``--seconds``, the check); one JSON line per seed on standard output with
every number the check computed.  ``--control`` puts the plain reference,
in TF32 (``reference/control.py``), in the program's place: it has to
come out not correct; ``--fault`` plants one of ``faults.py``'s faults.  The benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=("half_batch", "altered", "frozen"))
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args()

    import torch

    from portbench import faults, harness
    from portbench.reference.control import Control

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in args.seeds:
        cell = harness.load_cell(args.workload, False)
        backend = Control(cell.config, args.device) if args.control else None
        if args.fault:
            backend = faults.Faulty(cell.config, args.device, args.fault)
        undo = faults.freeze_optimizers() if args.fault == "frozen" else None
        start = time.perf_counter()
        result, lines = harness.run(cell, seed, args.seconds, False, args.device, start, backend=backend)
        if undo:
            undo()
        print("\n".join(lines[-len(cell.limits):]), file=sys.stderr, flush=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control, "fault": args.fault,
                          "correct": result["correct"], "calls": result["attempted"],
                          "readings": result["readings"],
                          "detail": next((ln for ln in lines if ln.startswith("program and reference")), None)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
