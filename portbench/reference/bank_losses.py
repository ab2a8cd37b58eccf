"""The filter-bank quality loss of a soft-orthogonal wavelet, from its
definition (ptwt's ``SoftOrthogonalWavelet.wavelet_loss``), in plain
PyTorch.

For a bank ``(dec_lo, dec_hi, rec_lo, rec_hi)`` of ``L`` taps each and
``a = [(-1)^n for n in L-1, ..., 0]``:

- perfect reconstruction: ``p = dec_lo * rec_lo + dec_hi * rec_hi`` (full
  convolutions); ``sum((p - 2 e_c)^2)``, ``e_c`` the unit vector at
  ``len(p) // 2``;
- alias cancellation: ``q = (a dec_lo) * rec_lo + (a dec_hi) * rec_hi``;
  ``sum(q^2)``;
- orthogonality: ``sum((dec_lo - rev(rec_lo))^2) + sum((dec_hi -
  rev(rec_hi))^2)``.

The loss is their sum.
"""

from __future__ import annotations

import torch


def convolve_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_k a[k] b[n - k]``, ``len(a) + len(b) - 1`` samples."""
    size = a.shape[0] + b.shape[0] - 1
    terms = [torch.nn.functional.pad(a[k] * b, (k, size - k - b.shape[0])) for k in range(a.shape[0])]
    return torch.stack(terms).sum(0)


def wavelet_loss(dec_lo, dec_hi, rec_lo, rec_hi) -> torch.Tensor:
    taps = dec_lo.shape[0]
    alt = torch.tensor([(-1.0) ** n for n in range(taps - 1, -1, -1)], dtype=dec_lo.dtype, device=dec_lo.device)
    p = convolve_full(dec_lo, rec_lo) + convolve_full(dec_hi, rec_hi)
    target = torch.zeros_like(p)
    target[p.shape[0] // 2] = 2.0
    q = convolve_full(dec_lo * alt, rec_lo) + convolve_full(dec_hi * alt, rec_hi)
    orth = ((dec_lo - rec_lo.flip(0)) ** 2).sum() + ((dec_hi - rec_hi.flip(0)) ** 2).sum()
    return ((p - target) ** 2).sum() + (q**2).sum() + orth


class Bank(torch.nn.Module):
    """A learnable bank with this module's loss: the control's stand-in
    for the program's ``SoftOrthogonalWavelet``."""

    def __init__(self, filters) -> None:
        super().__init__()
        self.dec_lo, self.dec_hi, self.rec_lo, self.rec_hi = (torch.nn.Parameter(f.detach().clone()) for f in filters)

    @property
    def filter_bank(self) -> tuple:
        return (self.dec_lo, self.dec_hi, self.rec_lo, self.rec_hi)

    def wavelet_loss(self) -> torch.Tensor:
        return wavelet_loss(*self.filter_bank)
