"""3d fast wavelet transform.

Counterpart of :mod:`ptwt_tpu.conv_transform_3`.  Every level runs through
:func:`~ptwt_tpu_torch.ops.analysis_nd` / :func:`~ptwt_tpu_torch.ops.synthesis_nd`:
three K3 launches per analysis level (one per axis, each on the packed
output of the last) and four K4 launches per synthesis level, for tensors
on the card; their plain torch versions for CPU tensors.  Detail
coefficients are stored per level in dicts keyed ``{"aad", "ada", "add",
"daa", "dad", "dda", "ddd"}`` (letter order follows the axis order,
a = low-pass, d = high-pass).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .constants import BoundaryMode, Wavelet, WaveletCoeffNd, WaveletDetailDict
from .conv_transform import _adjust_padding_at_reconstruction, _check_dtype
from .ops import analysis_nd, synthesis_nd
from .utils import (
    SUBBAND_ORDERS,
    as_device_tensor,
    coeff_tree_map,
    get_filter_arrays,
    infer_periodization,
    invalid_coeffs_message,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)
from .wavelets import dwt_max_level

__all__ = ["wavedec3", "waverec3"]

#: Per-level detail keys in the subband order of
#: :func:`~ptwt_tpu_torch.ops.analysis_nd` (subband 0 is the approximation
#: "aaa").
_DETAIL_KEYS = [
    "".join("d" if bit else "a" for bit in sel) for sel in SUBBAND_ORDERS[3][1:]
]


def wavedec3(
    data,
    wavelet: Union[Wavelet, str],
    *,
    mode: BoundaryMode = "zero",
    level: Optional[int] = None,
    axes: tuple[int, int, int] = (-3, -2, -1),
) -> WaveletCoeffNd:
    """Compute the 3d analysis (forward) fast wavelet transform.

    Args:
        data: Tensor with at least three dimensions; by default the last
            three axes are transformed, any leading axes are batch.  The
            transform runs on the tensor's device; anything that is not a
            tensor is moved to the CUDA device.
        wavelet: Wavelet name or pywt-compatible wavelet object.
        mode: Boundary extension mode. Defaults to ``zero``.
        level: Number of levels; computed from the signal shape if None.
        axes: The three axes to transform.

    Returns:
        ``(cA_n, {"aad": ..., ..., "ddd": ...}_n, ..., {...}_1)``.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> vol = torch.ones(16, 16, 16)
        >>> cA, details = ptwt.wavedec3(vol, "haar", level=1)
        >>> sorted(details)
        ['aad', 'ada', 'add', 'daa', 'dad', 'dda', 'ddd']
        >>> tuple(cA.shape)
        (8, 8, 8)
    """
    data = as_device_tensor(data)
    _check_dtype(data.dtype)
    data, ds = preprocess_tensor(data, ndim=3, axes=axes)
    dec_lo, dec_hi, _, _ = get_filter_arrays(wavelet, flip=True, dtype=data.dtype)
    filt_len = len(dec_lo)

    if level is None:
        level = min(dwt_max_level(s, filt_len) for s in data.shape[-3:])

    result_lst: list[WaveletDetailDict] = []
    res_lll = data
    for _ in range(level):
        res = analysis_nd(res_lll, dec_lo, dec_hi, mode=mode, ndim=3)
        res_lll = res[0]
        result_lst.append({key: res[i + 1] for i, key in enumerate(_DETAIL_KEYS)})

    result_lst.reverse()
    coeffs: WaveletCoeffNd = (res_lll, *result_lst)
    return postprocess_coeffs(coeffs, ndim=3, ds=ds, axes=axes)


def waverec3(
    coeffs: WaveletCoeffNd,
    wavelet: Union[Wavelet, str],
    *,
    axes: Union[Sequence[int], None] = None,
    mode: Optional[BoundaryMode] = None,
) -> torch.Tensor:
    """Reconstruct a 3d signal from :func:`wavedec3` coefficients.

    Args:
        coeffs: The coefficient tuple produced by :func:`wavedec3`.  Arrays
            that are not tensors are moved to the CUDA device.
        wavelet: Wavelet name or object (must match the decomposition).
        axes: The transformed axes (last three if None).
        mode: Only relevant when the analysis used ``periodization``; for
            all padded modes the inverse is mode-independent.  ``None``
            (the default) infers periodization from an exactly-halving
            coefficient chain on all three axes; pass a mode explicitly to
            override, and always for haar or single-level periodization
            chains.

    Returns:
        The reconstructed tensor.

    Raises:
        ValueError: On malformed coefficient containers or mismatched shapes.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> vol = torch.ones(10, 12, 14, dtype=torch.float64)
        >>> rec = ptwt.waverec3(ptwt.wavedec3(vol, "db2", level=2), "db2")
        >>> bool(torch.allclose(rec[:10, :12, :14], vol))
        True
    """
    for coeff_dict in coeffs[1:]:
        if not isinstance(coeff_dict, dict) or len(coeff_dict) != 7:
            raise ValueError(invalid_coeffs_message("dict containing 7 arrays", coeff_dict))
    coeffs = coeff_tree_map(as_device_tensor, coeffs)
    coeffs, ds = preprocess_coeffs(coeffs, ndim=3, axes=axes)
    dtype = coeffs[0].dtype
    _check_dtype(dtype)
    _, _, rec_lo, rec_hi = get_filter_arrays(wavelet, flip=False, dtype=dtype)
    filt_len = len(rec_lo)
    if mode is None:
        inferred = all(
            infer_periodization([d["aad"].shape[ax] for d in coeffs[1:]], filt_len)
            for ax in (-3, -2, -1)
        )
        mode = "periodization" if inferred else "zero"

    res_lll = coeffs[0]
    coeff_dicts = coeffs[1:]
    for c_pos, coeff_dict in enumerate(coeff_dicts):
        for coeff in coeff_dict.values():
            if coeff.shape != res_lll.shape:
                raise ValueError("All coefficients on each level must have the same shape")
        if mode == "periodization":
            pads = {ax: [0, 0] for ax in (-3, -2, -1)}
            res_sizes = {ax: 2 * res_lll.shape[ax] for ax in (-3, -2, -1)}
        else:
            pad = (2 * filt_len - 3) // 2
            pads = {ax: [pad, pad] for ax in (-3, -2, -1)}
            res_sizes = {ax: 2 * (res_lll.shape[ax] - 1) + filt_len for ax in (-3, -2, -1)}
        if c_pos + 1 < len(coeff_dicts):
            next_shape = coeff_dicts[c_pos + 1]["aad"].shape
            for ax in (-3, -2, -1):
                end, start = _adjust_padding_at_reconstruction(
                    res_sizes[ax], next_shape[ax], pads[ax][1], pads[ax][0]
                )
                pads[ax] = [start, end]
        res_lll = synthesis_nd(
            (res_lll, *(coeff_dict[key] for key in _DETAIL_KEYS)),
            rec_lo,
            rec_hi,
            pads=[tuple(pads[ax]) for ax in (-3, -2, -1)],
            mode=mode,
            ndim=3,
        )

    return postprocess_tensor(res_lll, ndim=3, ds=ds, axes=axes)
