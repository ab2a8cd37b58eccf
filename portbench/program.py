"""The system under test: the port's public transforms, as a cell's
configuration names them.

The only module of the harness that imports ``ptwt_tpu_torch``.  A loop
calls :meth:`Program.analysis` and :meth:`Program.synthesis`; the control
(:class:`portbench.reference.control.Control`) has the same two methods.
"""

from __future__ import annotations

import torch


class Program:
    def __init__(self, config: dict, device) -> None:
        import ptwt_tpu_torch as ptwt

        entries = config["entry_points"]
        self._analysis = getattr(ptwt, entries[0])
        self._synthesis = getattr(ptwt, entries[1])
        self.mode, self.level = config["mode"], config["level"]

    def analysis(self, x: torch.Tensor, wavelet):
        return self._analysis(x, wavelet, mode=self.mode, level=self.level)

    def synthesis(self, coeffs, wavelet) -> torch.Tensor:
        return self._synthesis(coeffs, wavelet, mode=self.mode)

    def learnable_bank(self, filters):
        """The port's learnable bank (``SoftOrthogonalWavelet``) made from
        ``(dec_lo, dec_hi, rec_lo, rec_hi)``."""
        from ptwt_tpu_torch.wavelets_learnable import SoftOrthogonalWavelet

        return SoftOrthogonalWavelet(*filters)


def launch_counts() -> dict:
    """The port's hand-kernel launches by name since the last reset."""
    from ptwt_tpu_torch.ops import _kernels

    return dict(_kernels.LAUNCHES)


def reset_launch_counts() -> None:
    from ptwt_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
