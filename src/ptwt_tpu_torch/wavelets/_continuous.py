"""Continuous wavelet functions (mexh, morl, gaus, cgau, cmor, shan, fbsp).

These are closed-form functions sampled on a grid (the reference obtains them
from ``pywt.ContinuousWavelet.wavefun``, used at
upstream ptwt ``src/ptwt/continuous_transform.py:86,211``).  The sampling
here is NumPy on the host; the CWT moves the sampled values to the device.
"""

from __future__ import annotations

import re
from functools import lru_cache

import numpy as np

__all__ = ["ContinuousWavelet", "parse_continuous_name"]

_CONT_PATTERNS = [
    (re.compile(r"^mexh$"), "mexh"),
    (re.compile(r"^morl$"), "morl"),
    (re.compile(r"^gaus(\d+)$"), "gaus"),
    (re.compile(r"^cgau(\d+)$"), "cgau"),
    (re.compile(r"^cmor(?:([\d.]+)-([\d.]+))?$"), "cmor"),
    (re.compile(r"^shan(?:([\d.]+)-([\d.]+))?$"), "shan"),
    (re.compile(r"^fbsp(?:(\d+)-([\d.]+)-([\d.]+))?$"), "fbsp"),
]


def parse_continuous_name(name: str) -> tuple:
    """Return (family, params) if `name` is a continuous wavelet, else None."""
    for pattern, family in _CONT_PATTERNS:
        match = pattern.match(name)
        if match:
            return family, match.groups()
    return None


@lru_cache(maxsize=None)
def _gaussian_derivative_norm(order: int, complex_variant: bool) -> float:
    """L2 normalization constant for the (complex) Gaussian derivative."""
    from scipy.integrate import quad

    x = None  # fine grid integration of |d^p/dx^p psi0|^2

    def sq(t: float) -> float:
        vals = _gaussian_derivative_values(np.array([t]), order, complex_variant)
        return float(np.abs(vals[0]) ** 2)

    norm_sq, _ = quad(sq, -10, 10, limit=400)
    del x
    return 1.0 / np.sqrt(norm_sq)


def _gaussian_derivative_values(
    x: np.ndarray, order: int, complex_variant: bool
) -> np.ndarray:
    """Unnormalized p-th derivative of exp(-x^2) (times exp(-ix) if complex)."""
    # represent d^p/dx^p [exp(-x^2) * (exp(-ix))] via polynomial recursion:
    # f = P(x) * exp(-x^2) * exp(-i c x), P' - (2x + i c) P  recursion.
    c = 1.0 if complex_variant else 0.0
    poly = np.zeros(order + 1, dtype=np.complex128)
    poly[0] = 1.0  # ascending powers
    for _ in range(order):
        dpoly = np.arange(1, poly.size) * poly[1:]
        new = np.zeros(poly.size + 1, dtype=np.complex128)
        new[: dpoly.size] = dpoly
        new[1:] -= 2.0 * poly  # -2x * P
        new[: poly.size] -= 1j * c * poly  # -i c * P
        poly = new
    vals = np.polyval(poly[::-1], x.astype(np.complex128))
    vals = vals * np.exp(-(x**2))
    if complex_variant:
        vals = vals * np.exp(-1j * c * x)
    return vals if complex_variant else np.real(vals)


class ContinuousWavelet:
    """A pywt-compatible continuous wavelet defined by a closed-form psi."""

    def __init__(self, name: str):
        parsed = parse_continuous_name(name)
        if parsed is None:
            raise ValueError(f"Unknown continuous wavelet {name!r}.")
        family, groups = parsed
        self.name = name
        self.family_name = family
        self.short_family_name = family
        self.orthogonal = False
        self.biorthogonal = False
        self.complex_cwt = family in ("cgau", "cmor", "shan", "fbsp")
        self.center_frequency: float = 0.0
        self.bandwidth_frequency: float = 0.0
        self.fbsp_order = 0
        self.dec_len = 0
        self.rec_len = 0

        if family in ("mexh", "morl"):
            self.lower_bound, self.upper_bound = -8.0, 8.0
        elif family in ("gaus", "cgau"):
            self.lower_bound, self.upper_bound = -5.0, 5.0
            self.order = int(groups[0])
            if not 1 <= self.order <= 8:
                raise ValueError(f"{family} order must be in 1..8.")
        elif family == "cmor":
            self.lower_bound, self.upper_bound = -8.0, 8.0
            self.bandwidth_frequency = float(groups[0]) if groups[0] else 1.5
            self.center_frequency = float(groups[1]) if groups[1] else 1.0
        elif family == "shan":
            self.lower_bound, self.upper_bound = -20.0, 20.0
            self.bandwidth_frequency = float(groups[0]) if groups[0] else 1.5
            self.center_frequency = float(groups[1]) if groups[1] else 1.0
        elif family == "fbsp":
            self.lower_bound, self.upper_bound = -20.0, 20.0
            self.fbsp_order = int(groups[0]) if groups[0] else 2
            self.bandwidth_frequency = float(groups[1]) if groups[1] else 1.0
            self.center_frequency = float(groups[2]) if groups[2] else 0.5

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Evaluate psi on the grid ``x``."""
        fam = self.family_name
        if fam == "mexh":
            return (
                2.0
                / (np.sqrt(3.0) * np.pi**0.25)
                * np.exp(-(x**2) / 2.0)
                * (1.0 - x**2)
            )
        if fam == "morl":
            return np.exp(-(x**2) / 2.0) * np.cos(5.0 * x)
        if fam in ("gaus", "cgau"):
            is_complex = fam == "cgau"
            vals = _gaussian_derivative_values(x, self.order, is_complex)
            return vals * _gaussian_derivative_norm(self.order, is_complex)
        if fam == "cmor":
            b, c = self.bandwidth_frequency, self.center_frequency
            return (
                (np.pi * b) ** -0.5
                * np.exp(-(x**2) / b)
                * np.exp(2j * np.pi * c * x)
            )
        if fam == "shan":
            b, c = self.bandwidth_frequency, self.center_frequency
            return np.sqrt(b) * np.sinc(b * x) * np.exp(2j * np.pi * c * x)
        if fam == "fbsp":
            m, b, c = self.fbsp_order, self.bandwidth_frequency, self.center_frequency
            return (
                np.sqrt(b)
                * np.sinc(b * x / m) ** m
                * np.exp(2j * np.pi * c * x)
            )
        raise AssertionError(fam)

    def wavefun(
        self, precision: int = 8, length: int | None = None
    ) -> tuple:
        """Sample psi on ``2**precision`` points of ``[lower, upper]``."""
        if length is None:
            length = 2**precision
        x = np.linspace(self.lower_bound, self.upper_bound, length)
        return self(x), x

    def __len__(self) -> int:
        return 0

    def __repr__(self) -> str:
        return f"ContinuousWavelet({self.name!r})"
