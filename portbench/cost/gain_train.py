"""Least work of a step of ``loops/gain_train.py``.

Every tensor of the step's data flow is written once where it is made and
read once, at the configuration's item size: ``u`` (read, and written by
the update), ``y`` (read), the bands, the scaled details, the
reconstruction, the residual, its gradient, the bands' and the details'
gradients, and ``u``'s gradient.  Products: the forward analysis and
synthesis and their transposes in the backward, each as many as the
forward's (:mod:`.shapes`).  The gains and the scalars are left out.
"""

from __future__ import annotations

from .shapes import transform


def cost(config: dict, mix: dict) -> tuple[float, float]:
    t = transform(config, mix["batch"])
    n, bands, details = t["input"], t["bands"], t["details"]
    elements = 2 * n + n + 2 * bands + 2 * details + 2 * n + 2 * n + 2 * n + 2 * bands + 2 * details + 2 * n
    return float(elements * t["itemsize"]), 4.0 * (t["analysis_macs"] + t["synthesis_macs"])
