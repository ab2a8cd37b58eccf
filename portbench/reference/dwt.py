"""Plain reference of the padded-mode fast wavelet transform (1d and 2d).

Written from the published definition (pywt's convention), with nothing
of the measured package: one axis at a time, each output sample the sum
over the taps of a tap times an input sample, the boundary given by the
mode's source-index map.  Analysis along an axis of length ``n`` with a
filter ``h`` of ``L`` taps gives ``m = (n + L - 1) // 2`` samples,

    lo[k] = sum_j dec_lo[j] * x[s(2k + 1 - j)],

``s`` the mode's map of an extended position to a source sample.  The
synthesis of a level is the full convolution of the zero-upsampled bands
with the reconstruction filters, cropped by ``L - 2`` on the left and to
``2m - L + 2`` samples (one fewer where the next finer band says the
level's input was odd).

Every sum runs in the dtype of its operands, float64 for the reference.
``cast`` (if given) rounds each operand of each product first: the
control (:mod:`.control`) runs the same arithmetic in float32 on operands
rounded to TF32, as a convolution with TF32 allowed would.  Nothing here
calls a convolution library, so ``allow_tf32`` does not reach it.  Coefficients come in the layouts the measured transforms
return: ``[cA_n, cD_n, ..., cD_1]`` in 1d and ``(cA_n, (H_n, V_n, D_n),
..., (H_1, V_1, D_1))`` in 2d, ``H`` high-pass along the rows' axis (-2)
and low along -1, ``V`` the other way round, ``D`` high along both.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import torch

Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]

_TAPS = Path(__file__).resolve().parent / "taps.json"


def bank(name: str, dtype: torch.dtype, device) -> tuple[torch.Tensor, ...]:
    """``(dec_lo, dec_hi, rec_lo, rec_hi)`` of an orthogonal wavelet from
    its published reconstruction low-pass (``taps.json``), by the
    quadrature-mirror relations ``dec_lo = rec_lo`` reversed, ``rec_hi[k]
    = (-1)^k rec_lo[L-1-k]``, ``dec_hi = rec_hi`` reversed."""
    rec_lo = torch.tensor(json.loads(_TAPS.read_text())[name], dtype=torch.float64)
    if rec_lo.shape[0] % 2:
        raise ValueError(f"{name}: an orthogonal bank has an even number of taps")
    n = rec_lo.shape[0]
    sign = torch.tensor([(-1.0) ** k for k in range(n)], dtype=torch.float64)
    rec_hi = sign * rec_lo.flip(0)
    filters = (rec_lo.flip(0), rec_hi.flip(0), rec_lo, rec_hi)
    return tuple(f.to(dtype=dtype, device=device) for f in filters)


def source_index(positions: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """The source sample of each extended position (-1: a zero)."""
    if mode == "periodic":
        return torch.remainder(positions, n)
    if mode == "zero":
        return torch.where((positions >= 0) & (positions < n), positions, -1)
    if mode == "constant":
        return positions.clamp(0, n - 1)
    if mode == "symmetric":
        q = torch.remainder(positions, 2 * n)
        return torch.where(q < n, q, 2 * n - 1 - q)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(positions)
        q = torch.remainder(positions, 2 * n - 2)
        return torch.where(q < n, q, 2 * n - 2 - q)
    raise ValueError(f"the reference has no mode {mode!r}")


def _op(t: torch.Tensor, cast: Cast) -> torch.Tensor:
    return t if cast is None else cast(t)


def analysis_axis(x: torch.Tensor, dec_lo, dec_hi, mode: str, axis: int, cast: Cast = None):
    """One analysis step along ``axis``: ``(lo, hi)``."""
    x = x.movedim(axis, -1)
    n, taps = x.shape[-1], dec_lo.shape[0]
    m = (n + taps - 1) // 2
    positions = torch.arange(2 - taps, 2 * m, device=x.device)
    src = source_index(positions, n, mode)
    ext = x.index_select(-1, src.clamp(min=0))
    if mode == "zero":
        ext = ext * (src >= 0).to(ext.dtype)
    ext = _op(ext, cast)
    lo = hi = None
    for j in range(taps):
        # extended position 2k + 1 - j sits at index 2k + taps - 1 - j
        window = ext[..., taps - 1 - j : taps - 1 - j + 2 * m - 1 : 2]
        a = _op(dec_lo[j], cast) * window
        b = _op(dec_hi[j], cast) * window
        lo = a if lo is None else lo + a
        hi = b if hi is None else hi + b
    return lo.movedim(-1, axis), hi.movedim(-1, axis)


def synthesis_axis(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, axis: int, out_len: int, cast: Cast = None):
    """One synthesis step along ``axis`` to ``out_len`` samples."""
    lo, hi = lo.movedim(axis, -1), hi.movedim(axis, -1)
    taps = rec_lo.shape[0]

    def upsampled(band):
        # [0, b0, 0, b1, ..., 0, b_{m-1}, 0]: position q of the upsampled
        # band at index q + 1, zeros beyond both ends
        z = torch.zeros_like(band)
        up = torch.stack((z, band), dim=-1).flatten(-2)
        return _op(torch.cat((up, z[..., :1]), dim=-1), cast)

    ulo, uhi = upsampled(lo), upsampled(hi)
    out = None
    for t in range(taps):
        start = taps - 1 - t
        term = _op(rec_lo[t], cast) * ulo[..., start : start + out_len] + _op(rec_hi[t], cast) * uhi[
            ..., start : start + out_len
        ]
        out = term if out is None else out + term
    return out.movedim(-1, axis)


def _out_len(m: int, taps: int, finer: Optional[int]) -> int:
    size = 2 * m - taps + 2
    if finer is not None and finer == size - 1:
        size -= 1
    return size


def wavedec(x: torch.Tensor, filters, mode: str, level: int, ndim: int, cast: Cast = None):
    """Coefficients of ``level`` analysis levels over the last ``ndim`` axes."""
    dec_lo, dec_hi = filters[0], filters[1]
    details = []
    approx = x
    for _ in range(level):
        if ndim == 1:
            approx, hi = analysis_axis(approx, dec_lo, dec_hi, mode, -1, cast)
            details.append(hi)
        elif ndim == 2:
            lo_w, hi_w = analysis_axis(approx, dec_lo, dec_hi, mode, -1, cast)
            approx, h_band = analysis_axis(lo_w, dec_lo, dec_hi, mode, -2, cast)
            v_band, d_band = analysis_axis(hi_w, dec_lo, dec_hi, mode, -2, cast)
            details.append((h_band, v_band, d_band))
        else:
            raise ValueError(f"the reference has no {ndim}d transform")
    details.reverse()
    return [approx, *details] if ndim == 1 else (approx, *details)


def waverec(coeffs, filters, ndim: int, cast: Cast = None) -> torch.Tensor:
    """The synthesis of :func:`wavedec`'s coefficients (uncropped at the
    finest level, as the measured transforms return it)."""
    rec_lo, rec_hi = filters[2], filters[3]
    taps = rec_lo.shape[0]
    approx = coeffs[0]
    for i in range(1, len(coeffs)):
        finer = coeffs[i + 1] if i + 1 < len(coeffs) else None
        if ndim == 1:
            size = _out_len(approx.shape[-1], taps, None if finer is None else finer.shape[-1])
            approx = synthesis_axis(approx, coeffs[i], rec_lo, rec_hi, -1, size, cast)
        else:
            h_band, v_band, d_band = coeffs[i]
            finer_shape = None if finer is None else finer[0].shape
            size_h = _out_len(approx.shape[-2], taps, None if finer is None else finer_shape[-2])
            size_w = _out_len(approx.shape[-1], taps, None if finer is None else finer_shape[-1])
            lo_w = synthesis_axis(approx, h_band, rec_lo, rec_hi, -2, size_h, cast)
            hi_w = synthesis_axis(v_band, d_band, rec_lo, rec_hi, -2, size_h, cast)
            approx = synthesis_axis(lo_w, hi_w, rec_lo, rec_hi, -1, size_w, cast)
    return approx


def bands(coeffs, ndim: int) -> list[torch.Tensor]:
    """Every band of a coefficient container, coarse to fine."""
    if ndim == 1:
        return list(coeffs)
    return [coeffs[0], *(band for triple in coeffs[1:] for band in triple)]
