"""Faults planted in the timed path, to read what each number of
``correct`` gives when the program is wrong: ``calibrate.py --fault`` on
the card, ``tests/test_portbench_mixes.py`` on the CPU.

- ``half_batch``: half of the batch left out; the other half's outputs
  stand for it, so a mean over the batch is a mean over the rest.
- ``altered``: an answer altered where it is produced: the finest detail
  band of the analysis off by 1e-3.
- ``frozen``: a step that leaves the state unchanged (the optimizer's
  step runs, its state fills, and the parameters are put back).
"""

from __future__ import annotations

import torch

from .program import Program

FAULTS = ("half_batch", "altered", "frozen")


class Faulty(Program):
    def __init__(self, config: dict, device, fault: str) -> None:
        super().__init__(config, device)
        if fault not in FAULTS:
            raise ValueError(f"no fault {fault!r}")
        self.fault = fault

    def analysis(self, x, wavelet):
        if self.fault == "half_batch":
            coeffs = super().analysis(x[: x.shape[0] // 2], wavelet)
            return torch.utils._pytree.tree_map(lambda t: torch.cat([t, t]), coeffs)
        coeffs = super().analysis(x, wavelet)
        if self.fault == "altered":
            coeffs = list(coeffs)
            last = coeffs[-1]
            coeffs[-1] = last * 1.001 if isinstance(last, torch.Tensor) else (last[0] * 1.001, *last[1:])
        return coeffs


def freeze_optimizers():
    """Make every SGD and Adam step leave the parameters as they were;
    returns a function that undoes it."""
    saved = {}
    for opt in (torch.optim.SGD, torch.optim.Adam):
        original = saved[opt] = opt.step

        def frozen(self, *args, _original=original, **kwargs):
            params = [p for g in self.param_groups for p in g["params"]]
            before = [p.detach().clone() for p in params]
            out = _original(self, *args, **kwargs)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return out

        opt.step = frozen

    def undo():
        for opt, original in saved.items():
            opt.step = original

    return undo
