"""The least work of a multi-level separable wavelet transform, from its
shapes alone, whatever kernel computes a level.

A level along an axis of ``n`` samples with ``L`` taps gives ``m = (n + L
- 1) // 2`` samples in the padded modes and ``ceil(n / 2)`` in
``periodization``.  Analysis, one axis at a time: every sample of every
band a pass writes is ``L`` products.  Synthesis, one axis at a time:
every output sample of a pass is ``L / 2`` products from each of its two
bands.  A level is counted in the cheaper order of its axes.  Bytes: the
input read once and every band written once (analysis), every band read
once and the output written once (synthesis).
"""

from __future__ import annotations

import itertools
import math


def halve(n: int, taps: int, mode: str) -> int:
    return (n + 1) // 2 if mode == "periodization" else (n + taps - 1) // 2


def levels(shape, taps: int, mode: str, level: int) -> list[tuple[tuple, tuple]]:
    """``(input, band)`` shapes of every analysis level, finest first."""
    out, cur = [], tuple(shape)
    for _ in range(level):
        band = tuple(halve(n, taps, mode) for n in cur)
        out.append((cur, band))
        cur = band
    return out


def analysis_macs(inp: tuple, band: tuple, taps: int) -> int:
    best = None
    for order in itertools.permutations(range(len(inp))):
        cur, bands, macs = list(inp), 1, 0
        for axis in order:
            cur[axis] = band[axis]
            bands *= 2
            macs += bands * math.prod(cur) * taps
        best = macs if best is None else min(best, macs)
    return best


def synthesis_macs(inp: tuple, band: tuple, taps: int) -> int:
    best = None
    for order in itertools.permutations(range(len(inp))):
        cur, bands, macs = list(band), 2 ** len(band), 0
        for axis in order:
            cur[axis] = inp[axis]
            bands //= 2
            macs += bands * math.prod(cur) * taps
        best = macs if best is None else min(best, macs)
    return best


def transform(config: dict, batch: int) -> dict:
    """Elements and products of one analysis and one synthesis of
    ``batch`` items of ``config``: ``input``, ``bands`` (every band of
    every level), ``details`` (the bands without the last approximation),
    ``analysis_macs``, ``synthesis_macs``, and ``itemsize`` in bytes."""
    lv = levels(config["shape"], config["taps"], config["mode"], config["level"])
    details = sum(math.prod(b) * (2 ** len(b) - 1) for _, b in lv)
    return {
        "input": batch * math.prod(config["shape"]),
        "details": batch * details,
        "bands": batch * (details + math.prod(lv[-1][1])),
        "analysis_macs": batch * sum(analysis_macs(i, b, config["taps"]) for i, b in lv),
        "synthesis_macs": batch * sum(synthesis_macs(i, b, config["taps"]) for i, b in lv),
        "itemsize": {"float32": 4, "float64": 8}[config["dtype"]],
    }
