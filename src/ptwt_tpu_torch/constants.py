"""Data model: wavelet protocol, coefficient containers, and mode literals.

PyTorch counterpart of :mod:`ptwt_tpu.constants`.  Coefficient containers
are plain tuples and NamedTuples of ``torch.Tensor``; the ``Wavelet``
protocol mirrors the pywt-style wavelet objects so user code written
against either package keeps working.
"""

from __future__ import annotations

from typing import Literal, NamedTuple, Optional, Protocol, Sequence, Union

import numpy as np
import torch

__all__ = [
    "SUPPORTED_DTYPES",
    "BoundaryMode",
    "ExtendedBoundaryMode",
    "PaddingMode",
    "OrthogonalizeMethod",
    "PacketNodeOrder",
    "Wavelet",
    "WaveletTensorTuple",
    "WaveletCoeff1d",
    "WaveletDetailTuple2d",
    "WaveletDetailDict",
    "WaveletCoeff2d",
    "WaveletCoeffNd",
    "WaveletCoeff2dSeparable",
]

#: Supported real compute dtypes; every kernel is built for both.
SUPPORTED_DTYPES = {torch.float32, torch.float64}

#: Signal-extension modes (pywt naming).  ``periodization`` is pywt's exact
#: length-N/2 circular DWT.
BoundaryMode = Literal[
    "constant", "zero", "reflect", "periodic", "symmetric", "periodization"
]

#: A padding mode, or ``boundary`` for the boundary-wavelet matrix backend
#: of the packet trees.
ExtendedBoundaryMode = Union[Literal["boundary"], BoundaryMode]

#: Padding used when a matrix transform meets an odd-length axis.
PaddingMode = Literal["full", "valid", "same", "sameshift"]

#: How the boundary-wavelet matrix transforms orthogonalize their deficient
#: boundary rows.
OrthogonalizeMethod = Literal["qr", "gramschmidt"]

#: The two node orders of a packet level.
PacketNodeOrder = Literal["natural", "freq"]


class Wavelet(Protocol):
    """Wavelet object interface, pywt-compatible."""

    name: str

    @property
    def dec_lo(self) -> Sequence[float]: ...  # noqa: D102

    @property
    def dec_hi(self) -> Sequence[float]: ...  # noqa: D102

    @property
    def rec_lo(self) -> Sequence[float]: ...  # noqa: D102

    @property
    def rec_hi(self) -> Sequence[float]: ...  # noqa: D102

    @property
    def dec_len(self) -> int: ...  # noqa: D102

    @property
    def rec_len(self) -> int: ...  # noqa: D102

    @property
    def filter_bank(
        self,
    ) -> tuple[Sequence[float], Sequence[float], Sequence[float], Sequence[float]]:
        """Return dec_lo, dec_hi, rec_lo, rec_hi."""
        ...

    def __len__(self) -> int:
        """Return the filter length."""
        ...


class WaveletTensorTuple(NamedTuple):
    """Filter bank as a tuple of tensors (e.g. learnable filters)."""

    dec_lo: torch.Tensor
    dec_hi: torch.Tensor
    rec_lo: torch.Tensor
    rec_hi: torch.Tensor

    @property
    def dec_len(self) -> int:
        """Length of the decomposition filters."""
        return self.dec_lo.shape[-1]

    @property
    def rec_len(self) -> int:
        """Length of the reconstruction filters."""
        return self.rec_lo.shape[-1]

    @property
    def filter_bank(self) -> "WaveletTensorTuple":
        """Return all four filter tensors."""
        return self

    @classmethod
    def from_wavelet(
        cls,
        wavelet: Wavelet,
        dtype: torch.dtype = torch.float32,
        device: Optional[torch.device] = None,
    ) -> "WaveletTensorTuple":
        """Build the tuple from any pywt-compatible wavelet object."""
        return cls(
            *(
                torch.as_tensor(np.asarray(f), dtype=dtype, device=device)
                for f in wavelet.filter_bank
            )
        )

    def __len__(self) -> int:
        """Return the decomposition filter length."""
        return self.dec_len


#: 1d coefficients ``[cA_n, cD_n, ..., cD_1]``.
WaveletCoeff1d = Sequence[torch.Tensor]


class WaveletDetailTuple2d(NamedTuple):
    """Detail coefficients (horizontal, vertical, diagonal) of a 2d level."""

    horizontal: torch.Tensor
    vertical: torch.Tensor
    diagonal: torch.Tensor


#: 2d coefficients ``(cA_n, (H_n, V_n, D_n), ..., (H_1, V_1, D_1))``.
WaveletCoeff2d = tuple

#: N-d detail coefficients keyed by per-axis filter strings like ``"aad"``.
WaveletDetailDict = dict

#: N-d coefficients ``(cA_n, {"aad": ...}, ...)``.
WaveletCoeffNd = tuple

#: Separable 2d coefficients (same container as N-d).
WaveletCoeff2dSeparable = tuple
