"""Learnable (adaptive) wavelet filter banks with quality losses.

Counterpart of :mod:`ptwt_tpu.wavelets_learnable`, in PyTorch's idiom: a
bank is an :class:`torch.nn.Module` holding its four filters as
:class:`torch.nn.Parameter` s (``dec_lo``, ``dec_hi``, ``rec_lo``,
``rec_hi``), so ``bank.parameters()`` go to any ``torch.optim`` optimizer.
``bank.filter_bank`` is accepted by every padded-mode transform of the
package, which differentiates with respect to it: on the card a bank that
requires grad runs every level per axis on the kernels K3/K4, and the
gradient of the taps on the kernel KT (``ops/_pallas2.py``).  The loss
terms follow the classical filter-bank conditions:

- alias cancellation ``F0(z)H0(-z) + F1(z)H1(-z) = 0``,
- perfect reconstruction ``P(z) + P(-z) = 2`` via the product filter,
- soft orthogonality (``LL^T = I`` and ``g[k] = h[-k]``).

The polynomial products are explicit torch ops (a padded unfold and a
product, exact in float64), so the losses run on the bank's device with
no convolution library.  :func:`bank_from_numpy` carries a ``ptwt_tpu``
bank's arrays across.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["WaveletFilter", "ProductFilter", "SoftOrthogonalWavelet"]

_NAMES = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")


def _convolve_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.convolve(a, b, "full")``: ``out[n] = sum_k a[k] b[n - k]``."""
    windows = F.pad(a, (b.shape[-1] - 1, b.shape[-1] - 1)).unfold(-1, b.shape[-1], 1)
    return (windows * b.flip(-1)).sum(-1)


def _correlate_valid(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``np.correlate(a, v, "valid")``: ``out[k] = sum_n a[n + k] v[n]``."""
    return (a.unfold(-1, v.shape[-1], 1) * v).sum(-1)


class WaveletFilter(nn.Module):
    """Base class: a four-filter bank with filter-quality losses.

    Args:
        dec_lo, dec_hi, rec_lo, rec_hi: The filters (tensors or arrays;
            copied into the module's parameters, keeping their dtype).
    """

    def __init__(self, dec_lo, dec_hi, rec_lo, rec_hi) -> None:
        super().__init__()
        for name, filt in zip(_NAMES, (dec_lo, dec_hi, rec_lo, rec_hi)):
            setattr(self, name, nn.Parameter(torch.as_tensor(filt).detach().clone()))

    @property
    def filter_bank(self) -> tuple:
        """Return (dec_lo, dec_hi, rec_lo, rec_hi)."""
        return (self.dec_lo, self.dec_hi, self.rec_lo, self.rec_hi)

    def __len__(self) -> int:
        """Filter length."""
        return self.dec_lo.shape[-1]

    @classmethod
    def from_wavelet(cls, wavelet, dtype: torch.dtype = torch.float64) -> "WaveletFilter":
        """Initialize the learnable bank from a registry wavelet."""
        from .utils import get_filter_arrays

        return cls(*get_filter_arrays(wavelet, flip=False, dtype=dtype))

    def _alternating_mask(self) -> torch.Tensor:
        length = self.dec_lo.shape[-1]
        return torch.tensor(
            [(-1.0) ** n for n in range(length)][::-1],
            dtype=self.dec_lo.dtype,
            device=self.dec_lo.device,
        )

    def pf_alias_cancellation_loss(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Product-filter alias cancellation: F0(z)=H1(-z), F1(z)=-H0(-z).

        Returns the scalar loss plus both residual vectors.
        """
        mask = self._alternating_mask()
        err1 = self.rec_lo - mask * self.dec_hi
        err2 = self.rec_hi - (-1.0) * mask * self.dec_lo
        return torch.sum(err1 * err1) + torch.sum(err2 * err2), err1, err2

    def alias_cancellation_loss(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Alias cancellation ``F0(z)H0(-z) + F1(z)H1(-z) = 0``.

        Polynomial products are full convolutions of the coefficient
        sequences.  Returns the scalar loss plus the residual polynomial.
        """
        mask = self._alternating_mask()
        p_lo = _convolve_full(self.dec_lo * mask, self.rec_lo)
        p_hi = _convolve_full(self.dec_hi * mask, self.rec_hi)
        p_test = p_lo + p_hi
        zeros = torch.zeros_like(p_test)
        return torch.sum(p_test * p_test), p_test, zeros

    def perfect_reconstruction_loss(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Product filter condition ``P(z) + P(-z) = 2`` at the center tap.

        Returns the scalar loss, the product filter, and the target.
        """
        p_lo = _convolve_full(self.dec_lo, self.rec_lo)
        p_hi = _convolve_full(self.dec_hi, self.rec_hi)
        p_test = p_lo + p_hi
        target = torch.zeros_like(p_test)
        target[p_test.shape[-1] // 2] = 2.0
        err = p_test - target
        return torch.sum(err * err), p_test, target

    def product_filter_loss(self) -> torch.Tensor:
        """PR loss + alias cancellation loss."""
        return self.perfect_reconstruction_loss()[0] + self.alias_cancellation_loss()[0]

    def wavelet_loss(self) -> torch.Tensor:
        """Total filter-quality loss (overridden by subclasses)."""
        return self.product_filter_loss()


class ProductFilter(WaveletFilter):
    """Learnable product filter: four free filter arrays.

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.wavelets_learnable import ProductFilter
        >>> bank = ProductFilter.from_wavelet("db3")
        >>> float(bank.wavelet_loss()) < 1e-10  # db3 is a perfect bank
        True
        >>> bank.wavelet_loss().backward()
        >>> tuple(bank.dec_lo.grad.shape)
        (6,)
    """


class SoftOrthogonalWavelet(ProductFilter):
    """Learnable filter bank with additional soft orthogonality losses."""

    def rec_lo_orthogonality_loss(self) -> torch.Tensor:
        """Soft ``LL^T = I``: stride-2 autocorrelation of the low-pass."""
        filt_len = self.dec_lo.shape[-1]
        padded = torch.cat([self.dec_lo, self.dec_lo.new_zeros(filt_len)])
        auto = _correlate_valid(padded, self.dec_lo)[::2]
        target = torch.zeros_like(auto)
        target[0] = 1.0
        err = auto - target
        return torch.sum(err * err)

    def filt_bank_orthogonality_loss(self) -> torch.Tensor:
        """Soft orthogonality ``g0[k] = h0[-k]`` and ``g1[k] = h1[-k]``."""
        eq0 = self.dec_lo - self.rec_lo.flip(-1)
        eq1 = self.dec_hi - self.rec_hi.flip(-1)
        return torch.sum(eq0 * eq0) + torch.sum(eq1 * eq1)

    def wavelet_loss(self) -> torch.Tensor:
        """Product filter loss plus the orthogonality constraints."""
        return self.product_filter_loss() + self.filt_bank_orthogonality_loss()


def bank_from_numpy(arrays: Any, cls: type = SoftOrthogonalWavelet) -> WaveletFilter:
    """Build a learnable bank of ``cls`` from a ``ptwt_tpu`` bank's filters.

    Args:
        arrays: ``(dec_lo, dec_hi, rec_lo, rec_hi)``, or any object with
            those four attributes (a ``ptwt_tpu.wavelets_learnable`` bank),
            each convertible with ``np.asarray``.
        cls: :class:`WaveletFilter`, :class:`ProductFilter` or
            :class:`SoftOrthogonalWavelet`.

    Returns:
        The bank on the CPU, in the arrays' dtype; move it with ``.to()``.
    """
    if all(hasattr(arrays, name) for name in _NAMES):
        arrays = tuple(getattr(arrays, name) for name in _NAMES)
    filters = tuple(arrays)
    if len(filters) != 4:
        raise ValueError(f"a filter bank has four filters, got {len(filters)}")
    return cls(*(torch.from_numpy(np.array(f)) for f in filters))
