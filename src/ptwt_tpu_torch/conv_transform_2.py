"""2d fast wavelet transform.

Counterpart of :mod:`ptwt_tpu.conv_transform_2`.  A ``periodization``
pyramid on an exactly halving chain runs as runs of fused levels (K5,
:mod:`~ptwt_tpu_torch.ops._pallas`) where the K5 plan holds it; every
other level runs through :func:`~ptwt_tpu_torch.ops.analysis_nd` /
:func:`~ptwt_tpu_torch.ops.synthesis_nd`.  Both launch the hand-written
CUDA kernels for tensors on the card and their plain torch versions for
CPU tensors.  Coefficient layout ``(cA_n, (H_n, V_n, D_n), ..., (H_1,
V_1, D_1))`` and odd-shape bookkeeping follow pywt.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .constants import (
    SUPPORTED_DTYPES,
    BoundaryMode,
    Wavelet,
    WaveletCoeff2d,
    WaveletDetailTuple2d,
)
from .conv_transform import _adjust_padding_at_reconstruction
from .ops import analysis_nd, synthesis_nd
from .ops._kernels import filters_traced
from .ops._pallas import fused_wavedec2d_applicable, fused_wavedec2d_per, fused_waverec2d_per
from .utils import (
    as_device_tensor,
    coeff_tree_map,
    filter_taps,
    infer_periodization,
    invalid_coeffs_message,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)
from .wavelets import dwt_max_level

__all__ = ["wavedec2", "waverec2"]


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"Unsupported dtype {dtype}: use float32 or float64.")


def _halving_chain(coeffs) -> bool:
    """Does every band of level ``i`` (coarse to fine) have ``cA``'s shape
    with the spatial axes doubled ``i - 1`` times?  A mismatch takes the
    per-level path, which raises for it."""
    ref = coeffs[0].shape
    return all(
        tuple(band.shape) == (*ref[:-2], ref[-2] << i, ref[-1] << i)
        for i, trip in enumerate(coeffs[1:])
        for band in trip
    )


def wavedec2(
    data,
    wavelet: Union[Wavelet, str],
    *,
    mode: BoundaryMode = "reflect",
    level: Optional[int] = None,
    axes: tuple[int, int] = (-2, -1),
) -> WaveletCoeff2d:
    """Compute the 2d analysis (forward) fast wavelet transform.

    Args:
        data: Tensor with at least two dimensions; by default the last two
            axes are transformed, any leading axes are batch.  The transform
            runs on the tensor's device; anything that is not a tensor is
            moved to the CUDA device.
        wavelet: Wavelet name or pywt-compatible wavelet object.
        mode: Boundary extension mode. Defaults to ``reflect``.
        level: Number of levels; computed from the signal shape if None.
        axes: The two axes to transform.

    Returns:
        ``(cA_n, (H_n, V_n, D_n), ..., (H_1, V_1, D_1))`` where each detail
        triple is a :class:`~ptwt_tpu_torch.constants.WaveletDetailTuple2d`.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> img = torch.arange(3 * 32 * 32, dtype=torch.float32)
        >>> coeffs = ptwt.wavedec2(img.reshape(3, 32, 32), "haar", level=2)
        >>> cA2, (H2, V2, D2), (H1, V1, D1) = coeffs
        >>> tuple(cA2.shape), tuple(D1.shape)
        ((3, 8, 8), (3, 16, 16))
    """
    data = as_device_tensor(data)
    _check_dtype(data.dtype)
    data, ds = preprocess_tensor(data, ndim=2, axes=axes)
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    filt_len = len(dec_lo)

    if level is None:
        level = min(dwt_max_level(s, filt_len) for s in data.shape[-2:])

    if (
        mode == "periodization"
        and not filters_traced(dec_lo, dec_hi)
        and fused_wavedec2d_applicable(data.shape[-2], data.shape[-1], filt_len, level, data.dtype)
    ):
        # the whole 2d pyramid in runs of fused levels (ops._pallas, K5)
        raw = fused_wavedec2d_per(data, dec_lo, dec_hi, level)
        coeffs = (raw[0], *(WaveletDetailTuple2d(*t) for t in raw[1:]))
        return postprocess_coeffs(coeffs, ndim=2, ds=ds, axes=axes)

    result_lst: list[WaveletDetailTuple2d] = []
    res_ll = data
    for _ in range(level):
        res_ll, res_lh, res_hl, res_hh = analysis_nd(
            res_ll, dec_lo, dec_hi, mode=mode, ndim=2
        )
        result_lst.append(WaveletDetailTuple2d(res_lh, res_hl, res_hh))

    result_lst.reverse()
    result: WaveletCoeff2d = (res_ll, *result_lst)
    return postprocess_coeffs(result, ndim=2, ds=ds, axes=axes)


def waverec2(
    coeffs: WaveletCoeff2d,
    wavelet: Union[Wavelet, str],
    *,
    axes: Union[Sequence[int], None] = None,
    mode: Optional[BoundaryMode] = None,
) -> torch.Tensor:
    """Reconstruct a 2d signal from :func:`wavedec2` coefficients.

    Args:
        coeffs: The coefficient tuple produced by :func:`wavedec2`.  Arrays
            that are not tensors are moved to the CUDA device.
        wavelet: Wavelet name or object (must match the decomposition).
        axes: The transformed axes (last two if None).
        mode: Only relevant when the analysis used ``periodization``.
            ``None`` (the default) infers periodization from an
            exactly-halving coefficient chain on both axes
            (:func:`~ptwt_tpu_torch.utils.infer_periodization`); pass a mode
            explicitly to override, and always for haar or single-level
            periodization chains, which carry no shape evidence.

    Returns:
        The reconstructed tensor.

    Raises:
        ValueError: On malformed coefficient containers or mismatched shapes.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> img = torch.ones(2, 31, 33)  # odd shapes round-trip too
        >>> rec = ptwt.waverec2(ptwt.wavedec2(img, "db3", level=2), "db3")
        >>> bool(torch.allclose(rec[..., :31, :33], img, atol=1e-5))
        True
    """
    for coeff_tuple in coeffs[1:]:
        if not isinstance(coeff_tuple, tuple) or len(coeff_tuple) != 3:
            raise ValueError(invalid_coeffs_message("3-tuple of arrays", coeff_tuple))
    coeffs = coeff_tree_map(as_device_tensor, coeffs)
    coeffs, ds = preprocess_coeffs(coeffs, ndim=2, axes=axes)
    dtype = coeffs[0].dtype
    _check_dtype(dtype)
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=dtype)
    filt_len = len(rec_lo)
    if mode is None:
        inferred = all(
            infer_periodization([t[0].shape[ax] for t in coeffs[1:]], filt_len)
            for ax in (-2, -1)
        )
        mode = "periodization" if inferred else "reflect"
    periodization = mode == "periodization"

    if (
        periodization
        and not filters_traced(rec_lo, rec_hi)
        and len(coeffs) >= 2
        and _halving_chain(coeffs)
        and fused_wavedec2d_applicable(
            2 * coeffs[-1][0].shape[-2], 2 * coeffs[-1][0].shape[-1], filt_len, len(coeffs) - 1, dtype
        )
    ):
        out = fused_waverec2d_per([coeffs[0]] + [tuple(t) for t in coeffs[1:]], rec_lo, rec_hi)
        return postprocess_tensor(out, ndim=2, ds=ds, axes=axes)

    res_ll = coeffs[0]
    for c_pos, coeff_tuple in enumerate(coeffs[1:]):
        for coeff in coeff_tuple:
            if coeff.shape != res_ll.shape:
                raise ValueError(
                    "All coefficients on each level must have the same shape"
                )
        if periodization:
            res_h, res_w = 2 * res_ll.shape[-2], 2 * res_ll.shape[-1]
            padl = padr = padt = padb = 0
        else:
            res_h = 2 * (res_ll.shape[-2] - 1) + filt_len
            res_w = 2 * (res_ll.shape[-1] - 1) + filt_len
            padl = padr = padt = padb = (2 * filt_len - 3) // 2
        if c_pos < len(coeffs) - 2:
            next_shape = coeffs[c_pos + 2][0].shape
            padr, padl = _adjust_padding_at_reconstruction(
                res_w, next_shape[-1], padr, padl
            )
            padb, padt = _adjust_padding_at_reconstruction(
                res_h, next_shape[-2], padb, padt
            )
        res_lh, res_hl, res_hh = coeff_tuple
        res_ll = synthesis_nd(
            (res_ll, res_lh, res_hl, res_hh),
            rec_lo,
            rec_hi,
            pads=[(padt, padb), (padl, padr)],
            mode=mode,
            ndim=2,
        )

    return postprocess_tensor(res_ll, ndim=2, ds=ds, axes=axes)
