"""Stationary (undecimated, a trous) wavelet transform.

Counterpart of :mod:`ptwt_tpu.stationary_transform`: per level, a dilated
(dilation ``2**level``) stride-1 filter-bank correlation with circular
padding; the inverse averages the two shift variants of the undecimated
synthesis.  Matches ``pywt.swt(trim_approx=True, norm=False)``.

The JAX package runs no Pallas kernel here, and neither does the port:
the dilated filter bank is a sum of ``filt_len`` unit-stride shifted
slices at offsets ``dilation * k``, plain torch ops on either device.  No
convolution routine is called (cuDNN would compute a float32 convolution
in TF32 by default).  The circular pad is a modulo index gather (the
``periodic`` map of :func:`.utils._padding.source_index`), which wraps
as often as a deep level's pad needs (``F.pad``'s ``circular`` mode
refuses a pad longer than the signal).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .constants import Wavelet, WaveletCoeff1d
from .conv_transform import _check_dtype
from .ops._slices import _taps
from .utils import (
    as_device_tensor,
    filter_taps,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)
from .wavelets import swt_max_level

__all__ = ["swt", "iswt"]


def _wrap(data: torch.Tensor, padl: int, padr: int) -> torch.Tensor:
    """Circular pad of the last axis by ``padl``/``padr``, any length: one
    gather whose index (``source_index``'s ``periodic`` map) is made on the
    data's device, so no host-to-device copy."""
    n = data.shape[-1]
    index = torch.arange(-padl, n + padr, device=data.device).remainder_(n)
    return torch.index_select(data, -1, index)


def _dilated_taps(data: torch.Tensor, filt, dilation: int) -> torch.Tensor:
    """``out[..., i] = sum_k filt[k] * data[..., i + dilation * k]``; a
    static tap is one fused multiply-add pass."""
    filt_len = len(filt)
    m = data.shape[-1] - dilation * (filt_len - 1)
    out = None
    for k in range(filt_len):
        sl = data[..., dilation * k : dilation * k + m]
        if out is None:
            out = filt[k] * sl
        elif isinstance(filt, torch.Tensor):
            out = out + filt[k] * sl
        else:
            out = torch.add(out, sl, alpha=filt[k])
    return out


def swt(
    data,
    wavelet: Union[Wavelet, str],
    level: Optional[int] = None,
    *,
    axis: Optional[int] = None,
) -> list[torch.Tensor]:
    """Compute a multilevel 1d stationary wavelet transform.

    Args:
        data: Input signal (leading axes are batch).  A tensor computes on
            its own device; anything else goes to the CUDA device.
        wavelet: Wavelet name or pywt-compatible object.
        level: Decomposition levels; ``swt_max_level`` of the signal length
            if None.
        axis: The axis to transform (last if None).

    Returns:
        ``[cA_n, cD_n, ..., cD_1]``; every entry has the input length
        (undecimated).  Equivalent to ``pywt.swt(trim_approx=True)``.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> x = torch.arange(32.0)
        >>> cA2, cD2, cD1 = ptwt.swt(x, "db1", level=2)
        >>> [int(c.shape[-1]) for c in (cA2, cD2, cD1)]
        [32, 32, 32]
    """
    data = as_device_tensor(data)
    _check_dtype(data.dtype)
    data, ds = preprocess_tensor(data, ndim=1, axes=axis)
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    dec_lo, dec_hi = _taps(dec_lo, data), _taps(dec_hi, data)
    filt_len = len(dec_lo)

    if level is None:
        level = swt_max_level(data.shape[-1])

    result = []
    res_lo = data
    for current_level in range(level):
        dilation = 2**current_level
        padded = _wrap(res_lo, dilation * (filt_len // 2 - 1), dilation * (filt_len // 2))
        res_hi = _dilated_taps(padded, dec_hi, dilation)
        res_lo = _dilated_taps(padded, dec_lo, dilation)
        result.append(res_hi)
    result.append(res_lo)
    result.reverse()
    return postprocess_coeffs(result, ndim=1, ds=ds, axes=axis)


def iswt(
    coeffs: WaveletCoeff1d,
    wavelet: Union[Wavelet, str],
    *,
    axis: Optional[int] = None,
) -> torch.Tensor:
    """Invert the 1d stationary wavelet transform of :func:`swt`.

    Per level the two shift variants of the undecimated synthesis are
    reconstructed as dilated correlations with the flipped reconstruction
    filters and averaged.
    """
    coeffs = [as_device_tensor(c) for c in coeffs]
    _check_dtype(coeffs[0].dtype)
    coeffs, ds = preprocess_coeffs(coeffs, ndim=1, axes=axis)
    # the transposed convolution is a correlation with the flipped filters
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=True, dtype=coeffs[0].dtype)
    rec_lo, rec_hi = _taps(rec_lo, coeffs[0]), _taps(rec_hi, coeffs[0])
    filt_len = len(rec_lo)

    res_lo = coeffs[0]
    for c_pos, res_hi in enumerate(coeffs[1:]):
        dilation = 2 ** (len(coeffs) - 2 - c_pos)
        padl, padr = dilation * (filt_len // 2), dilation * (filt_len // 2 - 1)
        rec_a = _dilated_taps(_wrap(res_lo, padl, padr), rec_lo, dilation)
        rec_b = _dilated_taps(_wrap(res_hi, padl, padr), rec_hi, dilation)
        res_lo = 0.5 * (rec_a + rec_b)
    return postprocess_tensor(res_lo, ndim=1, ds=ds, axes=axis)
