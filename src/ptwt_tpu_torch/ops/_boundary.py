"""Boundary-wavelet operator construction (host-side, NumPy float64).

Counterpart of :mod:`ptwt_tpu.ops._boundary`, a copy of its host code with
the filters taken from this package's registry.  Boundary-wavelet
transform matrices are banded; the matrix transforms apply them as dense
products (or, past the long-signal cutoff, through
:mod:`._boundary_long`).  Construction happens once per (length, wavelet)
on the host and is cached by the matrix-transform classes.

- strided convolution matrix with the ``sameshift`` row selection;
- deficient boundary rows (fewer than ``filt_len`` entries)
  re-orthogonalized by QR of their transpose or by Gram-Schmidt.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "conv_matrix",
    "strided_conv_matrix",
    "deficient_rows",
    "orthogonalize_rows",
    "boundary_analysis_matrix",
    "boundary_synthesis_matrix",
    "chain_fused_operator",
]


def conv_matrix(filt: np.ndarray, n: int, mode: str = "valid") -> np.ndarray:
    """Dense convolution matrix ``C`` with ``C @ x == conv(x, filt)[sel]``.

    Modes: ``full`` (all n+L-1 rows), ``same``/``sameshift`` (n centered
    rows, center offset ``L//2 - 1 + L%2``), ``valid``.
    """
    filt = np.asarray(filt, dtype=np.float64)
    filt_len = filt.shape[0]
    full = np.zeros((n + filt_len - 1, n))
    for col in range(n):
        full[col : col + filt_len, col] = filt
    if mode == "full":
        return full
    if mode in ("same", "sameshift"):
        start = filt_len // 2 - 1 + filt_len % 2
        return full[start : start + n]
    if mode == "valid":
        return full[filt_len - 1 : n]
    raise ValueError(f"Padding mode '{mode}' not supported.")


def strided_conv_matrix(
    filt: np.ndarray, n: int, stride: int = 2, mode: str = "valid"
) -> np.ndarray:
    """Strided convolution matrix (``sameshift`` keeps rows ``1::stride``)."""
    matrix = conv_matrix(filt, n, mode)
    offset = 1 if mode == "sameshift" else 0
    return matrix[offset::stride]


def deficient_rows(matrix: np.ndarray, filt_len: int) -> np.ndarray:
    """Indices of rows with fewer nonzero entries than ``filt_len``."""
    counts = np.count_nonzero(matrix, axis=1)
    return np.nonzero(counts != filt_len)[0]


def orthogonalize_rows(
    matrix: np.ndarray, filt_len: int, method: str = "qr"
) -> np.ndarray:
    """Re-orthonormalize the deficient boundary rows of a wavelet matrix.

    ``qr``: replace the deficient rows with the Q columns of a QR
    decomposition of their transpose (the reference's dense-QR scheme).
    ``gramschmidt``: sequential Gram-Schmidt of the deficient rows against
    previously processed ones.
    """
    rows = deficient_rows(matrix, filt_len)
    if rows.size == 0:
        return matrix
    result = matrix.copy()
    if method == "qr":
        sel = matrix[rows]
        q, _ = np.linalg.qr(sel.T)
        result[rows] = q.T
        return result
    if method == "gramschmidt":
        done: list[int] = []
        for row_idx in rows:
            current = result[row_idx].copy()
            for done_idx in done:
                current -= (result[row_idx] @ result[done_idx]) * result[done_idx]
            result[row_idx] = current / np.linalg.norm(current)
            done.append(int(row_idx))
        return result
    raise ValueError(f"Invalid orthogonalization method: {method}")


def _filter_bank(wavelet) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    if isinstance(wavelet, str):
        from ..wavelets import Wavelet

        wavelet = Wavelet(wavelet)
    return tuple(np.asarray(f, dtype=np.float64) for f in wavelet.filter_bank)


def boundary_analysis_matrix(
    wavelet, length: int, method: str = "qr"
) -> np.ndarray:
    """Orthogonal analysis matrix ``A`` of shape ``[length, length]``.

    The top ``length//2`` rows are the low-pass branch, the bottom half the
    high-pass branch; interior rows are the stride-2 ``sameshift``
    convolution, boundary rows are QR-orthonormalized (reference
    ``matmul_transform.py:47-170``).
    """
    dec_lo, dec_hi, _, _ = _filter_bank(wavelet)
    a_lo = strided_conv_matrix(dec_lo, length, 2, "sameshift")
    a_hi = strided_conv_matrix(dec_hi, length, 2, "sameshift")
    analysis = np.concatenate([a_lo, a_hi], axis=0)
    return orthogonalize_rows(analysis, dec_lo.shape[0], method)


def boundary_synthesis_matrix(
    wavelet, length: int, method: str = "qr"
) -> np.ndarray:
    """Orthogonal synthesis matrix ``S`` with ``S @ A = I``.

    Built from the flipped reconstruction filters and transposed
    (reference ``matmul_transform.py:84-118, 467-499``).
    """
    _, _, rec_lo, rec_hi = _filter_bank(wavelet)
    s_lo = strided_conv_matrix(rec_lo[::-1], length, 2, "sameshift")
    s_hi = strided_conv_matrix(rec_hi[::-1], length, 2, "sameshift")
    synthesis = np.concatenate([s_lo, s_hi], axis=0)
    filt_len = rec_lo.shape[0]
    return orthogonalize_rows(synthesis, filt_len, method).T


def chain_fused_operator(level_matrices: list[np.ndarray]) -> np.ndarray:
    """Fuse per-level operators into one matrix (analysis direction).

    Each level's matrix acts on the low-pass prefix of the running
    coefficient vector while an identity passes the accumulated detail
    coefficients through — the dense equivalent of the reference's
    ``cat_sparse_identity_matrix`` chaining (``sparse_math.py:99-151``).
    """
    total = max(m.shape[1] for m in level_matrices)
    fused = np.eye(total)
    for matrix in level_matrices:
        step = np.eye(total)
        step[: matrix.shape[0], : matrix.shape[1]] = matrix
        fused = step @ fused
    return fused
