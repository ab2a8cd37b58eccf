"""Fully separable 2d and 3d fast wavelet transforms (fswavedec/fswaverec).

Counterpart of :mod:`ptwt_tpu.separable_conv_transform`.  There, each
level applies the one-level 1d ``wavedec``/``waverec`` along every axis in
turn, band by band.  Here each axis pass is one call of the per-axis
route (:func:`~ptwt_tpu_torch.ops._dispatch.dwt_axis_packed` / :func:`~ptwt_tpu_torch.ops._dispatch.idwt_axis_pairs`)
on every sibling band at once, with the same values and no copy of the
tensor:

* analysis: one K3 launch per axis, last axis first, each on the packed
  output of the last (the siblings ride in the kernel's ``outer``);
* synthesis: first axis first, the (lo, hi) pairs of an axis two to a K4
  launch, each pair cropped as a one-level ``waverec`` crops it (the
  padded-mode crop: ``waverec`` infers no periodization from one detail).

Detail dicts are keyed by per-axis ``a``/``d`` strings, the first letter
for the first transformed axis, as ``pywt.fswavedecn`` keys them.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Union

import numpy as np
import torch

from .constants import (
    BoundaryMode,
    Wavelet,
    WaveletCoeff2dSeparable,
    WaveletCoeffNd,
    WaveletDetailDict,
)
from .conv_transform import _check_dtype
from .ops._dispatch import dwt_axis_packed, idwt_axis_pairs
from .utils import (
    as_device_tensor,
    coeff_tree_map,
    get_filter_arrays,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)

__all__ = ["fswavedec2", "fswavedec3", "fswaverec2", "fswaverec3"]


def _separable_dwtn(data: torch.Tensor, dec_lo, dec_hi, mode: BoundaryMode) -> WaveletDetailDict:
    """One separable analysis level of ``[batch, *spatial]`` over every
    spatial axis: a dict of ``2**ndim`` bands, letter i for spatial axis i
    (``a`` = low-pass, ``d`` = high-pass)."""
    ndim = data.ndim - 1
    packed = data
    for i in range(ndim):
        # the last axis first: each pass puts its (lo, hi) bit in front
        packed = dwt_axis_packed(packed, -1 - i, dec_lo, dec_hi, mode)
    # [2 (first axis), ..., 2 (last axis), batch, *bands]: one unbind, whose
    # backward stacks the cotangents once
    keys = ["".join(letters) for letters in itertools.product("ad", repeat=ndim)]
    return dict(zip(keys, packed.flatten(0, ndim - 1).unbind(0)))


def _crop_pair(a: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """Crop the approximation ``a`` to the detail ``d`` (a deeper level's
    reconstruction may carry one padded sample per axis) and check that the
    pair can be synthesised along ``axis``."""
    if a.shape != d.shape:  # (a full-extent slice would cost a copy in the backward)
        a = a[tuple(slice(0, s) for s in d.shape)]
        if a.shape[axis] != d.shape[axis]:
            raise ValueError("coefficients on each level must have the same shape")
        if a.shape != d.shape:
            raise TypeError(
                f"the (a, d) pair of shapes {tuple(a.shape)} and {tuple(d.shape)} "
                "differs off the transformed axis"
            )
    return a


def _separable_idwtn(bands: WaveletDetailDict, rec_lo, rec_hi) -> torch.Tensor:
    """Invert :func:`_separable_dwtn`: the first axis first, each pair of
    bands that differ only in the first letter merged into the band keyed
    by the remaining letters.  Pairs go in the order of ``bands``' ``a``
    keys, as ``ptwt_tpu`` takes them, so a malformed dict fails on the
    same pair."""
    filt_len = len(rec_lo)
    pad = (2 * filt_len - 3) // 2
    while True:
        a_keys = [k for k in bands if k[0] == "a"]
        axis = -len(a_keys[0])
        merged: dict[str, torch.Tensor] = {}
        while a_keys:
            # K4 takes two (lo, hi) pairs of one shape per launch
            group: list[tuple[str, torch.Tensor, torch.Tensor]] = []
            for a_key in a_keys[:2]:
                d = bands["d" + a_key[1:]]
                a = _crop_pair(bands[a_key], d, axis)
                if group and a.shape != group[0][1].shape:
                    break
                group.append((a_key[1:], a, d))
            rec = idwt_axis_pairs(
                [a for _, a, _ in group], [d for _, _, d in group], axis, rec_lo, rec_hi, pad, pad, "reflect"
            )
            merged.update(zip([key for key, _, _ in group], rec.unbind(0)))
            a_keys = a_keys[len(group) :]
        if "" in merged:
            return merged[""]
        bands = merged


def _fswavedecn(
    data, wavelet, ndim: int, *, mode: BoundaryMode, level: Optional[int], axes
) -> WaveletCoeffNd:
    data = as_device_tensor(data)
    _check_dtype(data.dtype)
    data, ds = preprocess_tensor(data, ndim=ndim, axes=axes)
    dec_lo, dec_hi, _, _ = get_filter_arrays(wavelet, flip=True, dtype=data.dtype)
    if level is None:
        wlen = len(dec_lo)
        level = int(min(math.log2(axis_len / (wlen - 1)) for axis_len in data.shape[1:]))
    result: list[WaveletDetailDict] = []
    approx = data
    for _ in range(level):
        bands = _separable_dwtn(approx, dec_lo, dec_hi, mode)
        approx = bands.pop("a" * ndim)
        result.append(bands)
    result.reverse()
    coeffs: WaveletCoeffNd = (approx, *result)
    return postprocess_coeffs(coeffs, ndim=ndim, ds=ds, axes=axes)


def _fswaverecn(coeffs: WaveletCoeffNd, wavelet, ndim: int, axes) -> torch.Tensor:
    if not isinstance(coeffs[0], (torch.Tensor, np.ndarray)):
        raise ValueError("approximation tensor must be first in coefficient list.")
    if not all(isinstance(c, dict) for c in coeffs[1:]):
        raise ValueError("All entries after approximation tensor must be dicts.")
    coeffs = coeff_tree_map(as_device_tensor, coeffs)
    coeffs, ds = preprocess_coeffs(coeffs, ndim=ndim, axes=axes)
    _check_dtype(coeffs[0].dtype)
    _, _, rec_lo, rec_hi = get_filter_arrays(wavelet, flip=False, dtype=coeffs[0].dtype)
    approx = coeffs[0]
    for level_dict in coeffs[1:]:
        level_dict = dict(level_dict)
        level_dict["a" * ndim] = approx
        approx = _separable_idwtn(level_dict, rec_lo, rec_hi)
    return postprocess_tensor(approx, ndim=ndim, ds=ds, axes=axes)


def fswavedec2(
    data,
    wavelet: Union[Wavelet, str],
    *,
    mode: BoundaryMode = "reflect",
    level: Optional[int] = None,
    axes=None,
) -> WaveletCoeff2dSeparable:
    """Fully separable 2d analysis transform.

    Args:
        data: Tensor with at least 2 dimensions (leading axes are batch).
            The transform runs on the tensor's device; anything that is not
            a tensor is moved to the CUDA device.
        wavelet: Wavelet name or pywt-compatible object.
        mode: Boundary extension mode. Defaults to ``reflect``.
        level: Decomposition levels (from the signal shape if None).
        axes: The two transform axes (last two if None).

    Returns:
        ``(cA_n, {"ad": ..., "da": ..., "dd": ...}_n, ..., {...}_1)``.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> img = torch.ones(5, 24, 24)
        >>> cA, d1 = ptwt.fswavedec2(img, "haar", level=1)
        >>> sorted(d1)
        ['ad', 'da', 'dd']
        >>> rec = ptwt.fswaverec2((cA, d1), "haar")
        >>> bool(torch.allclose(rec, img, atol=1e-6))
        True
    """
    return _fswavedecn(data, wavelet, ndim=2, mode=mode, level=level, axes=axes)


def fswavedec3(
    data,
    wavelet: Union[Wavelet, str],
    *,
    mode: BoundaryMode = "reflect",
    level: Optional[int] = None,
    axes=None,
) -> WaveletCoeffNd:
    """Fully separable 3d analysis transform (see :func:`fswavedec2`)."""
    return _fswavedecn(data, wavelet, ndim=3, mode=mode, level=level, axes=axes)


def fswaverec2(
    coeffs: WaveletCoeff2dSeparable,
    wavelet: Union[Wavelet, str],
    *,
    axes=None,
) -> torch.Tensor:
    """Invert :func:`fswavedec2`.

    The synthesis is the padded one of a one-level ``waverec`` along each
    axis, whatever mode the analysis used: a ``periodization`` analysis
    does not round-trip (one level comes back shorter, and deeper chains
    raise ``ValueError``), as in ``ptwt_tpu``.
    """
    return _fswaverecn(coeffs, wavelet, ndim=2, axes=axes)


def fswaverec3(
    coeffs: WaveletCoeffNd,
    wavelet: Union[Wavelet, str],
    *,
    axes=None,
) -> torch.Tensor:
    """Invert :func:`fswavedec3` (see :func:`fswaverec2`)."""
    return _fswaverecn(coeffs, wavelet, ndim=3, axes=axes)
