"""Least work of a round trip: one analysis and one synthesis
(:mod:`.shapes`).  Returns ``(bytes, operations)``, a product-and-sum
counted as two operations."""

from __future__ import annotations

from .shapes import transform


def cost(config: dict, mix: dict) -> tuple[float, float]:
    t = transform(config, mix["batch"])
    elements = (t["input"] + t["bands"]) + (t["bands"] + t["input"])
    return float(elements * t["itemsize"]), 2.0 * (t["analysis_macs"] + t["synthesis_macs"])
