"""Least work of a step of ``loops/learn_bank.py``.

Every tensor of the step's data flow written once and read once, at the
configuration's item size: the signals (read), the bands, the
reconstruction, the residual, its gradient, the bands' gradients and the
details' gradients.  Products: the forward analysis and synthesis; in the
backward the synthesis's transpose (the bands' gradients), the synthesis
filters' gradient (as many products as the synthesis) and the analysis
filters' gradient (as many as the analysis).  The propagation of
gradients through the deeper levels' approximations and the bank's own
quality loss are left out.
"""

from __future__ import annotations

from .shapes import transform


def cost(config: dict, mix: dict) -> tuple[float, float]:
    t = transform(config, mix["batch"])
    n, bands, details = t["input"], t["bands"], t["details"]
    elements = n + 2 * bands + 2 * n + 2 * n + 2 * n + 2 * bands + 2 * details
    macs = 3 * t["analysis_macs"] + 2 * t["synthesis_macs"]
    return float(elements * t["itemsize"]), 2.0 * macs
