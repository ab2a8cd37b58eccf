"""Learning a wavelet for compression: a learnable bank
(``SoftOrthogonalWavelet`` in float32) trained with Adam on fresh seeded
signals per step.

The bank starts from the configuration's wavelet (the frozen taps of
``reference/taps.json``) with seeded noise of ``init_noise`` added to
every tap, as a bank stands while it trains: at a perfect bank the
reconstruction filters' gradient is round-off alone, which Adam scales
to full steps, so two correct programs part after one step.

``loss = sparsity_weight * sum_bands mean|detail| + fidelity_weight *
mean((synthesis(analysis(x)) - x)^2) + quality_weight * wavelet_loss()``,
ptwt's learnable-wavelet compression example at the configuration's
shape.  A step ends in ``loss.item()``.
"""

from __future__ import annotations

import torch

from .. import common
from ..reference import checks
from . import base

NAMES = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")


class Loop(base.TrainLoop):
    def setup(self) -> None:
        start = checks.initial_bank(self.config, self.mix, self.seed, self.device)
        self.bank = self.backend.learnable_bank([f.to(torch.float32) for f in start])
        self.opt = torch.optim.Adam(self.bank.parameters(), lr=self.mix["adam_lr"])
        params = dict(zip(NAMES, self.bank.filter_bank))
        self.recorded = self.record(params)

    def loss(self, x: torch.Tensor) -> torch.Tensor:
        filters = self.bank.filter_bank
        coeffs = self.backend.analysis(x, filters)
        rec = common.crop(self.backend.synthesis(coeffs, filters), self.config["shape"])
        sparsity = sum(d.abs().mean() for d in common.detail_bands(coeffs, self.ndim))
        fidelity = ((rec - x) ** 2).mean()
        mix = self.mix
        return (
            mix["sparsity_weight"] * sparsity
            + mix["fidelity_weight"] * fidelity
            + mix["quality_weight"] * self.bank.wavelet_loss()
        )

    def release(self) -> None:
        super().release()
        self.bank = None

    def check(self) -> dict:
        start = checks.initial_bank(self.config, self.mix, self.seed, self.device)
        ref = checks.learn_steps(start, self.make_input, self.config, self.mix, base.RECORDED_STEPS)
        self.detail = {"program": self.recorded, "reference": ref}
        return checks.compare_training(self.recorded, ref)
