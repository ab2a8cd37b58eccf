"""The spread of a cell's metrics over sets of runs, and the bound it
suggests.

    python3 portbench/spread.py SET1_FILE SET2_FILE [...]

Each file holds the result lines (the last stdout line of ``run.py``) of
one set of runs of one cell, one per line.  For each metric it prints
every set's median and spread (the distance between the first and third
quartiles of ``statistics.quantiles(values, n=4)``, over the median), the
widest spread, and five times it, the bound to start from (never under
1%).
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    median = statistics.median(values)
    return 0.0 if q3 == q1 else (q3 - q1) / abs(median) if median else float("inf")


def main(paths: list[str]) -> None:
    sets = []
    for path in paths:
        lines = [json.loads(ln) for ln in open(path) if ln.strip().startswith("{")]
        sets.append(lines)
    names = sorted({n for s in sets for line in s for n in line["metrics"]})
    for name in names:
        rows = [[line["metrics"][name]["value"] for line in s if name in line["metrics"]] for s in sets]
        rows = [r for r in rows if len(r) >= 2]
        if not rows:
            continue
        spreads = [spread(r) for r in rows]
        medians = [statistics.median(r) for r in rows]
        wide = max(spreads)
        print(json.dumps({"metric": name, "medians": medians, "spreads": spreads, "widest": wide,
                          "bound": max(0.01, 5 * wide), "runs": [len(r) for r in rows]}))


if __name__ == "__main__":
    main(sys.argv[1:])
