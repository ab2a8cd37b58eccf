"""Banded DWT operators as dense matrices: the reduced-precision route.

Counterpart of :mod:`ptwt_tpu.ops._matmul`.  One FWT level along one axis
(the boundary extension folded together with the stride-2 filter bank) is
a banded ``[2*m, n]`` matrix, and its synthesis a ``[out, 2*m]`` one.
Under a reduced precision (:func:`~._conv.set_precision` below
``"highest"``) :mod:`._dispatch` applies them as one GEMM per axis and
level (:func:`~._conv.axis_matmul`) on every axis of at most
:func:`get_matmul_max_length` samples, as the JAX package does.

The operators are built once per ``(length, taps, mode)`` on the host in
float64 with vectorised index arithmetic (the same values as the JAX
package's builders, whose native ``native/ptwt_native.cc`` path is not
bound here), cached under a byte cap, and copied to each (dtype, device)
they are used on once: below ``"highest"`` on the card as the aligned
operand the product takes (:func:`~._conv.aligned_operator`), so the cap
counts every byte the route keeps.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

from ._conv import aligned_operator, operand_dtype
from ._kernels import host_taps
from ._library import constant_tensor

__all__ = [
    "analysis_matrix",
    "analysis_operator",
    "get_matmul_max_length",
    "set_matmul_max_length",
    "synthesis_matrix",
    "synthesis_operator",
]

#: Longest axis (analysis input, synthesis output) that the dense route
#: takes under a reduced precision; longer axes keep their exact kernels.
#: The JAX package's value.
MATMUL_MAX_LENGTH = 2048

#: Total bytes each operator cache (host float64, device copies) may hold.
#: A float64 operator near ``MATMUL_MAX_LENGTH`` is ~34 MB; evicting by
#: size keeps a sweep over many lengths from pinning gigabytes.
OPERATOR_CACHE_BYTES = 512 * 1024 * 1024


def set_matmul_max_length(n: int) -> None:
    """Set the axis-length cutoff of the dense-operator route."""
    global MATMUL_MAX_LENGTH
    MATMUL_MAX_LENGTH = n


def get_matmul_max_length() -> int:
    """Current axis-length cutoff of the dense-operator route."""
    return MATMUL_MAX_LENGTH


def _source_index(p: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Map (possibly out-of-range) extended positions to source indices.

    The pywt boundary extensions as index maps; -1 where a position
    contributes nothing (``zero``).  Positions are relative to the
    unpadded signal (may be negative or >= n).
    """
    if mode == "valid":
        return p
    if mode == "zero":
        return np.where((p >= 0) & (p < n), p, -1)
    if mode == "periodic":
        return np.mod(p, n)
    if mode == "constant":
        return np.clip(p, 0, n - 1)
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(p)
        period = 2 * n - 2
        q = np.mod(p, period)
        return np.where(q < n, q, period - q)
    if mode == "symmetric":
        period = 2 * n
        q = np.mod(p, period)
        return np.where(q < n, q, period - 1 - q)
    if mode == "periodization":
        # replicate-pad odd lengths to even, then wrap (utils.fwt_pad)
        n_eff = n + (n % 2)
        q = np.mod(p, n_eff)
        return np.minimum(q, n - 1)
    raise ValueError(f"Padding mode not supported: {mode}")


class _BytesLRU:
    """LRU cache of arrays or tensors (or of values that ``size`` measures),
    capped by their total bytes."""

    def __init__(self, size: Callable[[object], int] = lambda v: v.nbytes) -> None:
        self._store: OrderedDict[Hashable, object] = OrderedDict()
        self._size = size

    def get(self, key: Hashable, build: Callable[[], object]):
        hit = self._store.get(key)
        if hit is not None:
            self._store.move_to_end(key)
            return hit
        val = constant_tensor(build())
        self._store[key] = val
        total = sum(self._size(v) for v in self._store.values())
        while total > OPERATOR_CACHE_BYTES and len(self._store) > 1:
            _, evicted = self._store.popitem(last=False)
            total -= self._size(evicted)
        return val

    def clear(self) -> None:
        self._store.clear()


_HOST = _BytesLRU()
_DEVICE = _BytesLRU()


def _summed(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """A ``shape`` matrix holding the sum of ``weights`` at each (row, col),
    added in the order given."""
    flat = (rows * shape[1] + cols).ravel()
    return np.bincount(flat, weights.ravel(), minlength=shape[0] * shape[1]).reshape(shape)


def _build_analysis(n: int, lo: tuple, hi: tuple, mode: str) -> np.ndarray:
    filt_len = len(lo)
    if mode == "valid":
        padl, npad = 0, n
    elif mode == "periodization":
        padl = filt_len // 2 - 1
        npad = n + (n % 2) + 2 * padl
    else:
        padl = (2 * filt_len - 3) // 2
        npad = n + 2 * padl + (n % 2)
    m = (npad - filt_len) // 2 + 1
    if m <= 0:
        return np.zeros((2 * m, n))  # numpy raises for m < 0, as the JAX builder does
    taps = np.arange(filt_len)[:, None]  # tap-major: each entry's sum adds in tap order
    rows = np.broadcast_to(np.arange(m), (filt_len, m))
    src = _source_index(2 * rows + taps - padl, n, mode)
    keep = src >= 0
    weights = np.broadcast_to(np.asarray(lo)[:, None], (filt_len, m))[keep]
    weights_hi = np.broadcast_to(np.asarray(hi)[:, None], (filt_len, m))[keep]
    rows, src = rows[keep], src[keep]
    return _summed(
        np.concatenate([rows, m + rows]), np.concatenate([src, src]),
        np.concatenate([weights, weights_hi]), (2 * m, n),
    )


def _build_synthesis(m: int, lo: tuple, hi: tuple, padl: int, padr: int, periodization: bool) -> np.ndarray:
    filt_len = len(lo)
    full = 2 * (m - 1) + filt_len
    # column j of each half is the filter placed at rows 2j .. 2j + L - 1;
    # column-major, so a folded entry adds its rows in increasing order
    cols = np.broadcast_to(np.arange(m)[:, None], (m, filt_len))
    rows = 2 * cols + np.arange(filt_len)
    n_rows = full
    if periodization:
        # wrap-add the filt_len//2 - 1 overhanging rows circularly
        # (periodization_wrap semantics) modulo the 2m rows, so the fold
        # stays exact when the overhang wraps several times
        n_rows = full - (filt_len - 2)  # == 2 * m
        rows = (rows - (filt_len // 2 - 1)) % max(n_rows, 1)
    mat = _summed(
        np.concatenate([rows, rows]), np.concatenate([cols, m + cols]),
        np.concatenate([np.broadcast_to(lo, (m, filt_len)), np.broadcast_to(hi, (m, filt_len))]),
        (n_rows, 2 * m),
    )
    return mat[padl : mat.shape[0] - padr] if padr > 0 else mat[padl:]


def _taps(filt) -> tuple:
    return tuple(host_taps(filt))


def _analysis_key(n: int, dec_lo, dec_hi, mode: str) -> tuple:
    return ("analysis", n, _taps(dec_lo), _taps(dec_hi), mode)


def _synthesis_key(m: int, rec_lo, rec_hi, padl: int, padr: int, periodization: bool) -> tuple:
    return ("synthesis", m, _taps(rec_lo), _taps(rec_hi), padl, padr, bool(periodization))


def _host(key: tuple) -> np.ndarray:
    build = _build_analysis if key[0] == "analysis" else _build_synthesis
    return _HOST.get(key, lambda: build(*key[1:]))


def _device(key: tuple, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The operator for a product of ``x`` and its aligned copy, cached per
    dtype and device: at ``"highest"`` the operator as ``x``'s dtype (and
    no copy); below it only the aligned copy is kept, and the operator is
    its leading block."""
    dtype = operand_dtype(x)
    if dtype is None:
        op = _DEVICE.get((key, x.dtype, x.device), lambda: torch.as_tensor(_host(key), dtype=x.dtype, device=x.device))
        return op, None
    aligned = _DEVICE.get(
        (key, dtype, x.device, "aligned"),
        lambda: aligned_operator(torch.as_tensor(_host(key), device=x.device), dtype),
    )
    rows, cols = _host(key).shape
    return aligned[:rows, :cols], aligned


def analysis_matrix(n: int, dec_lo, dec_hi, mode: str) -> torch.Tensor:
    """Mode-folded one-level analysis operator ``[2*m, n]`` (float64, CPU).

    ``dec_lo``/``dec_hi`` must already be flipped (correlation order), as
    ``get_filter_arrays(..., flip=True)`` returns them.  Rows ``[:m]``
    give the approximation, rows ``[m:]`` the detail.  ``mode="valid"``
    takes a signal padded beforehand.
    """
    return torch.from_numpy(_host(_analysis_key(n, dec_lo, dec_hi, mode)))


def synthesis_matrix(
    m: int, rec_lo, rec_hi, padl: int, padr: int, periodization: bool = False
) -> torch.Tensor:
    """One-level synthesis operator ``[out_len, 2*m]`` (float64, CPU).

    The stride-2 transposed convolution with the (unflipped)
    reconstruction pair, the periodization wrap if asked, and the
    ``padl``/``padr`` crop in one matrix; its input is ``[lo; hi]``
    concatenated along the coefficient axis.
    """
    return torch.from_numpy(_host(_synthesis_key(m, rec_lo, rec_hi, padl, padr, periodization)))


def analysis_operator(n: int, dec_lo, dec_hi, mode: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`analysis_matrix` for a product of ``x``, and its aligned copy
    (:func:`~._conv.axis_matmul`'s ``matrix`` and ``aligned``), cached."""
    return _device(_analysis_key(n, dec_lo, dec_hi, mode), x)


def synthesis_operator(
    m: int, rec_lo, rec_hi, padl: int, padr: int, periodization: bool, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`synthesis_matrix` for a product of ``x``, and its aligned copy
    (:func:`~._conv.axis_matmul`'s ``matrix`` and ``aligned``), cached."""
    return _device(_synthesis_key(m, rec_lo, rec_hi, padl, padr, periodization), x)
