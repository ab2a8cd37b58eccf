"""Self-contained wavelet registry (pywt-compatible API).

The reference depends on PyWavelets for coefficient tables and level formulas
(``pywt.Wavelet``, ``pywt.dwt_max_level``, ``pywt.ContinuousWavelet``, used
throughout upstream ptwt ``src/ptwt/``).  This package computes every
filter bank from first principles on the host (see ``_orthogonal.py``,
``_biorthogonal.py``, ``_continuous.py``) and mirrors the small pywt API
surface the transforms need.
"""

from __future__ import annotations

import math
import re
from functools import lru_cache
from typing import Sequence, Union

import numpy as np

from ._biorthogonal import bior_filter_pair, dmey_rec_lo
from ._continuous import ContinuousWavelet, parse_continuous_name
from ._orthogonal import coiflet_rec_lo, daubechies_rec_lo, symlet_rec_lo

__all__ = [
    "Wavelet",
    "ContinuousWavelet",
    "DiscreteContinuousWavelet",
    "wavelist",
    "dwt_max_level",
    "dwtn_max_level",
    "swt_max_level",
    "central_frequency",
    "scale2frequency",
]

_DISCRETE_NAME = re.compile(
    r"^(haar|db(\d+)|sym(\d+)|coif(\d+)|bior(\d)\.(\d)|rbio(\d)\.(\d)|dmey)$"
)


def _qmf_bank(dec_lo: np.ndarray, rec_lo: np.ndarray):
    """Derive (dec_lo, dec_hi, rec_lo, rec_hi) from the two low-pass filters.

    Uses the pywt quadrature relation (verified against the pywt tables):
    ``dec_hi[n] = (-1)**(n+1) rec_lo[n]`` and ``rec_hi[n] = (-1)**n dec_lo[n]``.
    """
    n = np.arange(dec_lo.size)
    dec_hi = rec_lo * (-1.0) ** (n + 1)
    rec_hi = dec_lo * (-1.0) ** n
    return dec_lo, dec_hi, rec_lo, rec_hi


@lru_cache(maxsize=None)
def _filter_bank_for(name: str):
    """Compute the four filters for a discrete wavelet name (cached)."""
    match = _DISCRETE_NAME.match(name)
    if match is None:
        raise ValueError(
            f"Unknown discrete wavelet {name!r}. Supported families: haar, "
            "db1-38, sym2-20, coif1-17, bior/rbio (spline + 4.4/5.5/6.8), dmey."
        )
    groups = match.groups()
    if name == "haar":
        rec_lo = np.array(daubechies_rec_lo(1))
        return _qmf_bank(rec_lo[::-1].copy(), rec_lo)
    if groups[1] is not None:  # db
        rec_lo = np.array(daubechies_rec_lo(int(groups[1])))
        return _qmf_bank(rec_lo[::-1].copy(), rec_lo)
    if groups[2] is not None:  # sym
        rec_lo = np.array(symlet_rec_lo(int(groups[2])))
        return _qmf_bank(rec_lo[::-1].copy(), rec_lo)
    if groups[3] is not None:  # coif
        rec_lo = np.array(coiflet_rec_lo(int(groups[3])))
        return _qmf_bank(rec_lo[::-1].copy(), rec_lo)
    if groups[4] is not None:  # bior
        dec_lo, rec_lo = bior_filter_pair(int(groups[4]), int(groups[5]))
        return _qmf_bank(np.array(dec_lo), np.array(rec_lo))
    if groups[6] is not None:  # rbio
        dec_lo, rec_lo = bior_filter_pair(int(groups[6]), int(groups[7]), reverse=True)
        return _qmf_bank(np.array(dec_lo), np.array(rec_lo))
    if name == "dmey":
        rec_lo = np.array(dmey_rec_lo())
        return _qmf_bank(rec_lo[::-1].copy(), rec_lo)
    raise AssertionError(name)


class Wavelet:
    """Discrete wavelet object with the pywt attribute surface.

    Satisfies the :class:`ptwt_tpu_torch.constants.Wavelet` protocol (which mirrors
    the reference protocol at upstream ptwt ``src/ptwt/constants.py:30-47``).

    Example:
        >>> from ptwt_tpu_torch.wavelets import Wavelet
        >>> w = Wavelet("db2")
        >>> w.dec_len, w.orthogonal
        (4, True)
        >>> [round(c, 6) for c in w.rec_lo]
        [0.482963, 0.836516, 0.224144, -0.12941]
    """

    def __init__(self, name: str, filter_bank=None):
        self.name = name
        if filter_bank is not None:
            bank = tuple(np.asarray(f, dtype=np.float64) for f in filter_bank)
        else:
            bank = _filter_bank_for(name)
        self._dec_lo, self._dec_hi, self._rec_lo, self._rec_hi = bank
        # the taps as python floats: reading them runs no numpy, so a
        # compiled transform takes them as constants
        self._taps = tuple(tuple(float(v) for v in f) for f in bank)
        family = re.match(r"^([a-z]+)", name)
        self.family_name = family.group(1) if family else name
        self.short_family_name = self.family_name
        self.orthogonal = self.family_name in ("haar", "db", "sym", "coif")
        self.biorthogonal = self.orthogonal or self.family_name in ("bior", "rbio")
        if self.family_name == "dmey":
            # only approximately orthogonal (truncated Meyer)
            self.orthogonal = True
            self.biorthogonal = True
        self.symmetry = (
            "asymmetric"
            if self.family_name == "db"
            else ("near symmetric" if self.family_name in ("sym", "coif") else "symmetric")
        )

    @property
    def dec_lo(self) -> list:
        """Decomposition low-pass filter."""
        return list(self._taps[0])

    @property
    def dec_hi(self) -> list:
        """Decomposition high-pass filter."""
        return list(self._taps[1])

    @property
    def rec_lo(self) -> list:
        """Reconstruction low-pass filter."""
        return list(self._taps[2])

    @property
    def rec_hi(self) -> list:
        """Reconstruction high-pass filter."""
        return list(self._taps[3])

    @property
    def dec_len(self) -> int:
        """Length of the decomposition filters."""
        return len(self._taps[0])

    @property
    def rec_len(self) -> int:
        """Length of the reconstruction filters."""
        return len(self._taps[2])

    @property
    def filter_bank(self) -> tuple:
        """(dec_lo, dec_hi, rec_lo, rec_hi) as lists."""
        return (self.dec_lo, self.dec_hi, self.rec_lo, self.rec_hi)

    def wavefun(self, level: int = 8) -> tuple:
        """Approximate (phi, psi, x) via the cascade algorithm.

        For biorthogonal wavelets returns (phi_d, psi_d, phi_r, psi_r, x),
        mirroring ``pywt.Wavelet.wavefun``.
        """

        def refine(first: np.ndarray, lo: np.ndarray) -> np.ndarray:
            # coarsest stage uses `first` (lo for phi, hi for psi), then
            # level-1 low-pass refinements: the standard cascade recursion.
            vals = np.sqrt(2.0) * first
            for _ in range(level - 1):
                up = np.zeros(2 * vals.size - 1)
                up[::2] = vals
                vals = np.sqrt(2.0) * np.convolve(up, lo)
            return vals

        def cascade(lo: np.ndarray, hi: np.ndarray):
            phi = refine(lo, lo)
            psi = refine(hi, lo)
            size = max(phi.size, psi.size)
            phi = np.pad(phi, (0, size - phi.size))
            psi = np.pad(psi, (0, size - psi.size))
            return phi, psi

        lo_r = self._rec_lo
        hi_r = self._rec_hi
        if self.orthogonal:
            phi, psi = cascade(lo_r, hi_r)
            x = np.linspace(0, self.rec_len - 1, phi.size)
            return phi, psi, x
        phi_r, psi_r = cascade(lo_r, hi_r)
        phi_d, psi_d = cascade(self._dec_lo[::-1], self._dec_hi[::-1])
        x = np.linspace(0, self.rec_len - 1, phi_r.size)
        return phi_d, psi_d, phi_r, psi_r, x

    def __len__(self) -> int:
        return self.dec_len

    def __repr__(self) -> str:
        return f"Wavelet({self.name!r})"


def DiscreteContinuousWavelet(name: str) -> object:
    """Return a :class:`Wavelet` or :class:`ContinuousWavelet` by name."""
    if parse_continuous_name(name) is not None:
        return ContinuousWavelet(name)
    return Wavelet(name)


def wavelist(family: str | None = None, kind: str = "all") -> list[str]:
    """List supported wavelet names (pywt-compatible helper)."""
    discrete = (
        ["haar"]
        + [f"db{i}" for i in range(1, 39)]
        + [f"sym{i}" for i in range(2, 21)]
        + [f"coif{i}" for i in range(1, 18)]
        + [
            f"bior{a}.{b}"
            for (a, b) in [(1, 1), (1, 3), (1, 5), (2, 2), (2, 4), (2, 6), (2, 8),
                           (3, 1), (3, 3), (3, 5), (3, 7), (3, 9), (4, 4), (5, 5), (6, 8)]
        ]
        + [
            f"rbio{a}.{b}"
            for (a, b) in [(1, 1), (1, 3), (1, 5), (2, 2), (2, 4), (2, 6), (2, 8),
                           (3, 1), (3, 3), (3, 5), (3, 7), (3, 9), (4, 4), (5, 5), (6, 8)]
        ]
        + ["dmey"]
    )
    continuous = (
        ["mexh", "morl"]
        + [f"gaus{i}" for i in range(1, 9)]
        + [f"cgau{i}" for i in range(1, 9)]
        + ["cmor", "shan", "fbsp"]
    )
    if kind == "discrete":
        names = discrete
    elif kind == "continuous":
        names = continuous
    else:
        names = discrete + continuous
    if family is not None:
        names = [n for n in names if n.startswith(family)]
    return names


def dwt_max_level(data_len: int, filter_len) -> int:
    """Max useful DWT level (pywt formula)."""
    if not isinstance(filter_len, int):
        filter_len = (
            filter_len.dec_len
            if hasattr(filter_len, "dec_len")
            else len(filter_len)
        )
    if filter_len < 2 or data_len < filter_len - 1:
        return 0
    return int(math.log2(data_len / (filter_len - 1)))


def dwtn_max_level(shape: Sequence[int], wavelet) -> int:
    """Max level for an N-d transform: the min over the axes."""
    if isinstance(wavelet, str):
        wavelet = Wavelet(wavelet)
    return min(dwt_max_level(s, wavelet.dec_len) for s in shape)


def swt_max_level(input_len: int) -> int:
    """Max SWT level: the number of times the length is divisible by two."""
    level = 0
    while input_len % 2 == 0 and input_len > 0:
        input_len //= 2
        level += 1
    return level


def central_frequency(wavelet, precision: int = 8) -> float:
    """Central frequency of a wavelet (pywt's FFT-peak algorithm)."""
    if isinstance(wavelet, str):
        wavelet = DiscreteContinuousWavelet(wavelet)
    if getattr(wavelet, "center_frequency", 0.0):
        return float(wavelet.center_frequency)
    functions = wavelet.wavefun(precision)
    if len(functions) == 2:
        psi, x = functions
    elif len(functions) == 3:
        _, psi, x = functions
    else:
        _, psi, _, _, x = functions
    domain = float(x[-1] - x[0])
    index = int(np.argmax(np.abs(np.fft.fft(psi)[1:]))) + 2
    if index > len(psi) / 2:
        index = len(psi) - index + 2
    return 1.0 / (domain / (index - 1))


def scale2frequency(wavelet, scale, precision: int = 8) -> float:
    """Convert scales to normalized frequencies (pywt-compatible)."""
    return central_frequency(wavelet, precision=precision) / np.asarray(scale)
