"""1d fast wavelet transform.

Counterpart of :mod:`ptwt_tpu.conv_transform`, with its routing and
bookkeeping line for line: ``periodization`` on an exactly halving chain
runs the whole pyramid through K6 (:mod:`.ops._pallas`); a long signal in
a padded mode runs its first levels in fused runs of up to four through
K8 (:mod:`.ops._pallas1d_multi`) and its last synthesis steps likewise;
every other level goes through :func:`~ptwt_tpu_torch.ops.analysis_nd` /
:func:`~ptwt_tpu_torch.ops.synthesis_nd` (K7 on a long axis, K3/K4
otherwise).  A filter bank that requires grad declines every fused route
(K6, K8 and K7), as the JAX package's gates decline a traced bank: each
level runs on K3/K4, whose backward also gives the filters' gradient.  CUDA tensors launch the hand-written kernels, CPU tensors
their plain torch versions.  Coefficient semantics (the pywt pad rule,
odd lengths, the order ``[cA_n, cD_n, ..., cD_1]``) follow pywt.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .constants import SUPPORTED_DTYPES, BoundaryMode, Wavelet, WaveletCoeff1d
from .ops import analysis_nd, synthesis_nd
from .ops._kernels import filters_traced
from .ops._pallas import (
    fused_wavedec1d_per,
    fused_wavedec_applicable,
    fused_waverec1d_per,
)
from .ops._pallas1d_multi import (
    flat_multi_depth,
    flat_multi_syn_depth,
    flat_wavedec_lane_multi,
    flat_waverec_lane_multi,
)
from .utils import (
    as_device_tensor,
    filter_taps,
    infer_periodization,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)
from .wavelets import dwt_max_level

__all__ = ["wavedec", "waverec"]


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"Unsupported dtype {dtype}: use float32 or float64.")


def _adjust_padding_at_reconstruction(
    res_size: int, coeff_size: int, pad_end: int, pad_start: int
) -> tuple[int, int]:
    """Resolve the odd-length crop ambiguity from the next level's shape.

    If removing the symmetric padding would leave one sample too many,
    crop one extra from the end.
    """
    pred_size = res_size - (pad_start + pad_end)
    if coeff_size == pred_size:
        pass
    elif coeff_size == pred_size - 1:
        pad_end += 1
    else:
        raise AssertionError(
            "padding error, please check if dec and rec wavelets are "
            "identical. (If the analysis used mode='periodization', pass "
            "mode='periodization' to the reconstruction as well — "
            "periodization coefficient chains have different lengths.)"
        )
    return pad_end, pad_start


def wavedec(
    data,
    wavelet: Union[Wavelet, str],
    *,
    mode: BoundaryMode = "reflect",
    level: Optional[int] = None,
    axis: int = -1,
) -> list[torch.Tensor]:
    """Compute the 1d analysis (forward) fast wavelet transform.

    Args:
        data: Input signal; by default the last axis is transformed, any
            leading axes are batch.  The transform runs on the tensor's
            device; anything that is not a tensor is moved to the CUDA
            device.
        wavelet: Wavelet name or pywt-compatible wavelet object.
        mode: Boundary extension mode. Defaults to ``reflect``.
        level: Number of decomposition levels; computed from the signal
            length if None.
        axis: Axis to transform. Defaults to -1.

    Returns:
        The coefficient list ``[cA_n, cD_n, ..., cD_1]``.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> x = torch.arange(16.0)
        >>> cA2, cD2, cD1 = ptwt.wavedec(x, "haar", mode="zero", level=2)
        >>> [int(c.shape[-1]) for c in (cA2, cD2, cD1)]
        [4, 4, 8]
    """
    data = as_device_tensor(data)
    _check_dtype(data.dtype)
    data, ds = preprocess_tensor(data, ndim=1, axes=axis)
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    filt_len = len(dec_lo)

    if level is None:
        level = dwt_max_level(data.shape[-1], filt_len)

    learn = filters_traced(dec_lo, dec_hi)
    if mode == "periodization" and not learn and fused_wavedec_applicable(data.shape[-1], filt_len, level):
        # the whole level pyramid: one read of the signal, one write per band
        result = fused_wavedec1d_per(data, dec_lo, dec_hi, level)
        return postprocess_coeffs(result, ndim=1, ds=ds, axes=axis)

    result: list[torch.Tensor] = []
    res_lo = data
    done = 0
    # long last axes: fuse runs of levels into one kernel launch each
    while done < level and not learn:
        depth = flat_multi_depth(res_lo.shape[-1], filt_len, mode, level - done)
        if depth < 2:
            break
        res_lo, his = flat_wavedec_lane_multi(res_lo, dec_lo, dec_hi, mode, depth)
        result.extend(his)
        done += depth
    for _ in range(level - done):
        res_lo, res_hi = analysis_nd(res_lo, dec_lo, dec_hi, mode=mode, ndim=1)
        result.append(res_hi)
    result.append(res_lo)
    result.reverse()

    return postprocess_coeffs(result, ndim=1, ds=ds, axes=axis)


def waverec(
    coeffs: WaveletCoeff1d,
    wavelet: Union[Wavelet, str],
    *,
    axis: Union[int, Sequence[int], None] = None,
    mode: Optional[BoundaryMode] = None,
) -> torch.Tensor:
    """Reconstruct a 1d signal from :func:`wavedec` coefficients.

    Args:
        coeffs: The coefficient list produced by :func:`wavedec`.  Arrays
            that are not tensors are moved to the CUDA device.
        wavelet: Wavelet name or pywt-compatible wavelet object (must match
            the decomposition wavelet).
        axis: The transformed axis (last if None).
        mode: Only relevant when the analysis used ``periodization`` — the
            circular synthesis differs; for all padded modes the inverse is
            mode-independent.  ``None`` (the default) infers periodization
            from an exactly-halving coefficient chain
            (:func:`~ptwt_tpu_torch.utils.infer_periodization`); pass a mode
            explicitly to override, and always for haar or single-level
            periodization chains, which carry no shape evidence.

    Returns:
        The reconstructed signal.

    Raises:
        ValueError: On mismatched coefficient lengths.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> x = torch.arange(16.0)
        >>> coeffs = ptwt.wavedec(x, "db2", level=2)
        >>> rec = ptwt.waverec(coeffs, "db2")
        >>> bool(torch.allclose(rec[..., :16], x, atol=1e-5))
        True
    """
    coeffs = [as_device_tensor(c) for c in coeffs]
    coeffs, ds = preprocess_coeffs(coeffs, ndim=1, axes=axis)
    dtype = coeffs[0].dtype
    _check_dtype(dtype)
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=dtype)
    filt_len = len(rec_lo)
    if mode is None:
        inferred = infer_periodization([c.shape[-1] for c in coeffs[1:]], filt_len)
        mode = "periodization" if inferred else "reflect"
    periodization = mode == "periodization"
    learn = filters_traced(rec_lo, rec_hi)

    if (
        periodization
        and not learn
        and len(coeffs) >= 2
        and all(
            c.shape[-1] == coeffs[0].shape[-1] * 2 ** max(i - 1, 0)
            for i, c in enumerate(coeffs)
        )
        and fused_wavedec_applicable(coeffs[-1].shape[-1] * 2, filt_len, len(coeffs) - 1)
    ):
        out = fused_waverec1d_per(list(coeffs), rec_lo, rec_hi)
        return postprocess_tensor(out, ndim=1, ds=ds, axes=axis)

    # static crop plan per step: the synthesis output length is known
    # before any kernel runs, so the odd-length ambiguity is resolved
    # from the next coefficient's shape up front and folded into the
    # synthesis operator
    steps = []  # (padl, padr, out_len) per step, coarse to fine
    m_cur = coeffs[0].shape[-1]
    for c_pos in range(len(coeffs) - 1):
        if coeffs[c_pos + 1].shape[-1] != m_cur:
            raise ValueError("coefficients on each level must have the same shape")
        if periodization:
            res_size = 2 * m_cur
            padl = padr = 0
        else:
            res_size = 2 * (m_cur - 1) + filt_len
            padl = padr = (2 * filt_len - 3) // 2
        if c_pos < len(coeffs) - 2:
            padr, padl = _adjust_padding_at_reconstruction(
                res_size, coeffs[c_pos + 2].shape[-1], padr, padl
            )
        m_cur = res_size - padl - padr
        steps.append((padl, padr, m_cur))

    fuse_from = len(steps)
    if not periodization and not learn:
        # long last axes: fuse the final (long) steps into one launch
        depth = flat_multi_syn_depth([s[2] for s in steps], filt_len, mode)
        if depth >= 2:
            fuse_from = len(steps) - depth

    res_lo = coeffs[0]
    for c_pos in range(fuse_from):
        padl, padr, _ = steps[c_pos]
        res_lo = synthesis_nd(
            (res_lo, coeffs[c_pos + 1]),
            rec_lo,
            rec_hi,
            pads=[(padl, padr)],
            mode=mode,
            ndim=1,
        )
    if fuse_from < len(steps):
        suffix = steps[fuse_from:]
        res_lo = flat_waverec_lane_multi(
            [res_lo] + list(coeffs[fuse_from + 1 :]),
            rec_lo,
            rec_hi,
            [s[0] for s in suffix][::-1],
            [s[2] for s in suffix][::-1],
        )

    return postprocess_tensor(res_lo, ndim=1, ds=ds, axes=axis)
