"""Training through a pyramid: an image (or signal) batch ``u`` as a
parameter and per-level, per-orientation gains ``g`` on its details.

``loss = mean((synthesis(cA, g * details) - y)^2) + energy_weight *
mean(details^2)`` over the unscaled details, ``y`` a fresh seeded target
per step; backward and one SGD step (``u`` at ``lr_u_per_element`` times
its size, the gradient being a mean over its elements; ``g`` at
``lr_g``).  A step ends in ``loss.item()``, as a logging training loop's
does.  Image restoration by gradient descent under a wavelet prior, and
models that train through a pyramid, run this path.
"""

from __future__ import annotations

import torch

from .. import common
from ..reference import checks
from . import base


class Loop(base.TrainLoop):
    def start(self) -> torch.Tensor:
        return common.normal(self.shape, self.device, self.seed, common.PARAMS, 0)

    def setup(self) -> None:
        orientations = 3 if self.ndim == 2 else 1
        self.u = torch.nn.Parameter(self.start())
        self.g = torch.nn.Parameter(torch.ones(self.config["level"], orientations, device=self.device))
        self.opt = torch.optim.SGD(
            [
                {"params": [self.u], "lr": self.mix["lr_u_per_element"] * self.u.numel()},
                {"params": [self.g], "lr": self.mix["lr_g"]},
            ]
        )
        self.recorded = self.record({"u": self.u, "g": self.g})

    def loss(self, y: torch.Tensor) -> torch.Tensor:
        wavelet = self.config["wavelet"]
        coeffs = self.backend.analysis(self.u, wavelet)
        if self.ndim == 2:
            scaled = [tuple(self.g[lev, o] * d for o, d in enumerate(t)) for lev, t in enumerate(coeffs[1:])]
            rec = self.backend.synthesis((coeffs[0], *scaled), wavelet)
        else:
            scaled = [self.g[lev, 0] * d for lev, d in enumerate(coeffs[1:])]
            rec = self.backend.synthesis([coeffs[0], *scaled], wavelet)
        details = common.detail_bands(coeffs, self.ndim)
        energy = sum((d**2).sum() for d in details)
        count = sum(d.numel() for d in details)
        rec = common.crop(rec, self.config["shape"])
        return ((rec - y) ** 2).mean() + self.mix["energy_weight"] * energy / count

    def release(self) -> None:
        super().release()
        self.u = self.g = None

    def check(self) -> dict:
        ref = checks.gain_steps(self.start(), self.make_input, self.config, self.mix, base.RECORDED_STEPS)
        self.detail = {"program": self.recorded, "reference": ref}
        return checks.compare_training(self.recorded, ref)
