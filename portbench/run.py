"""Benchmark of ptwt_tpu_torch on CUDA devices: one cell per run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (BENCHMARK.json), measures for ``--seconds``, checks the
timed path's outputs against the plain reference and prints the result as
one JSON object, the last line of standard output; the compared numbers
and their limits are the last lines of standard error.  With ``--trace 1``
the metrics are the per-layer ones, read from the window and a profile
of a few calls after it.  Without the CUDA devices the cell asks for, it
prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
_CACHE = CHECKOUT / "build" / "portbench-cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(_CACHE / _sub)
sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not load in a run were loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
