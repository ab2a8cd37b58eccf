"""3d boundary-wavelet transforms (separable) as dense matrix products.

Counterpart of :mod:`ptwt_tpu.matmul_transform_3`: per-axis orthogonal
boundary operators applied along the three spatial axes, one product per
axis and level; the eight subband blocks become the ``{"aad", ...,
"ddd"}`` detail dict.  A long axis (past
:func:`~.ops.long_boundary_cutoff`) runs the O(n) banded apply along its
own axis (K3 and K4 on the card).  Every product runs at
:func:`~.ops.get_precision`.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import torch

from .constants import OrthogonalizeMethod, Wavelet, WaveletCoeffNd
from .conv_transform import _check_dtype
from .matmul_transform import (
    BaseMatrixWaveDec,
    _as_wavelet_obj,
    _check_orthogonal,
    _operator,
    _plan_levels,
)
from .matmul_transform_2 import _apply_axis, _pad_odd_axes
from .ops._boundary import boundary_analysis_matrix, boundary_synthesis_matrix
from .ops._boundary_long import LongAnalysisOp, LongSynthesisOp, long_boundary_cutoff, long_supported
from .utils import (
    SUBBAND_ORDERS,
    as_device_tensor,
    coeff_tree_map,
    deprecated_alias,
    invalid_coeffs_message,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)

__all__ = ["MatrixWavedec3", "MatrixWaverec3"]

_DETAIL_KEYS_3D = ["".join("d" if bit else "a" for bit in sel) for sel in SUBBAND_ORDERS[3][1:]]


def _block(sel, n_d: int, n_h: int, n_w: int) -> tuple:
    """The index of one subband block of a packed ``[B, 2n_d, 2n_h, 2n_w]``
    level: each axis's lo (0) or hi (1) half."""
    return (slice(None),) + tuple(
        slice(n, None) if bit else slice(None, n) for bit, n in zip(sel, (n_d, n_h, n_w))
    )


class MatrixWavedec3(BaseMatrixWaveDec):
    """3d boundary-wavelet analysis through cached per-axis operators.

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.matmul_transform_3 import MatrixWavedec3
        >>> cA, details = MatrixWavedec3("haar", level=1)(torch.ones(8, 8, 8))
        >>> tuple(cA.shape), sorted(details)
        ((4, 4, 4), ['aad', 'ada', 'add', 'daa', 'dad', 'dda', 'ddd'])
    """

    @deprecated_alias(boundary="orthogonalization")
    def __init__(
        self,
        wavelet: Union[Wavelet, str],
        level: Optional[int] = None,
        *,
        axes: tuple[int, int, int] = (-3, -2, -1),
        orthogonalization: OrthogonalizeMethod = "qr",
        odd_coeff_padding_mode: str = "zero",
    ):
        self.wavelet = _as_wavelet_obj(wavelet)
        _check_orthogonal(self.wavelet)
        self.level = level
        self.axes = axes
        self.orthogonalization = orthogonalization
        self.odd_coeff_padding_mode = odd_coeff_padding_mode
        self.input_signal_shape: Optional[tuple[int, int, int]] = None
        self.fwt_matrix_list: list = []
        self._dtype = None
        self._device = None
        self._built_level: Optional[int] = None

    def _build(self, shape: tuple[int, int, int], like: torch.Tensor) -> None:
        filt_len = self.wavelet.dec_len
        plans = [_plan_levels(s, self.level, filt_len) for s in shape]
        level = min(p[0] for p in plans)
        if self.level is not None and level < self.level:
            warnings.warn(
                f"Signal shape {shape} supports only {level} levels for this "
                f"wavelet; clamping from {self.level}."
            )
        self._built_level = level
        cutoff = long_boundary_cutoff()

        def axis_op(length):
            if length > cutoff and long_supported(self.wavelet, length, self.orthogonalization):
                return LongAnalysisOp(self.wavelet, length, self.orthogonalization)
            return _operator(boundary_analysis_matrix(self.wavelet, length, self.orthogonalization), like)

        self.fwt_matrix_list = [tuple(axis_op(plans[ax][1][lvl]) for ax in range(3)) for lvl in range(level)]

    def __call__(self, input_signal) -> WaveletCoeffNd:
        """Compute the 3d boundary-wavelet coefficients."""
        data = as_device_tensor(input_signal)
        _check_dtype(data.dtype)
        data, ds = preprocess_tensor(data, ndim=3, axes=self.axes)
        shape = tuple(data.shape[-3:])
        if (
            self.input_signal_shape != shape
            or self._built_level is None
            or self._dtype != data.dtype
            or self._device != data.device
        ):
            self._build(shape, data)
            self.input_signal_shape = shape
            self._dtype = data.dtype
            self._device = data.device

        result_lst = []
        res = data
        for ops3 in self.fwt_matrix_list:
            coeffs = _pad_odd_axes(res, (-3, -2, -1))
            for axis, op in zip((-3, -2, -1), ops3):
                coeffs = _apply_axis(coeffs, op, axis)
            n_d, n_h, n_w = (op.shape[0] // 2 for op in ops3)
            result_lst.append(
                {key: coeffs[_block(sel, n_d, n_h, n_w)] for sel, key in zip(SUBBAND_ORDERS[3][1:], _DETAIL_KEYS_3D)}
            )
            res = coeffs[:, :n_d, :n_h, :n_w]

        result_lst.reverse()
        coeffs_out: WaveletCoeffNd = (res, *result_lst)
        return postprocess_coeffs(coeffs_out, ndim=3, ds=ds, axes=self.axes)


class MatrixWaverec3:
    """Inverse of :class:`MatrixWavedec3`.

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.matmul_transform_3 import MatrixWavedec3, MatrixWaverec3
        >>> vol = torch.ones(8, 8, 8)
        >>> rec = MatrixWaverec3("haar")(MatrixWavedec3("haar", level=2)(vol))
        >>> bool(torch.allclose(rec, vol, atol=1e-6))
        True
    """

    @deprecated_alias(boundary="orthogonalization")
    def __init__(
        self,
        wavelet: Union[Wavelet, str],
        *,
        axes: tuple[int, int, int] = (-3, -2, -1),
        orthogonalization: OrthogonalizeMethod = "qr",
    ):
        self.wavelet = _as_wavelet_obj(wavelet)
        _check_orthogonal(self.wavelet)
        self.axes = axes
        self.orthogonalization = orthogonalization
        self.ifwt_matrix_list: list = []
        self._built_shapes: list = []
        self._dtype = None
        self._device = None

    def _build(self, shapes, like: torch.Tensor) -> None:
        cutoff = long_boundary_cutoff()

        def axis_op(length):
            if length > cutoff and long_supported(self.wavelet, length, self.orthogonalization):
                return LongSynthesisOp(self.wavelet, length, self.orthogonalization)
            return _operator(boundary_synthesis_matrix(self.wavelet, length, self.orthogonalization), like)

        self.ifwt_matrix_list = [tuple(axis_op(axis_len) for axis_len in shape) for shape in shapes]
        self._built_shapes = shapes
        self._dtype = like.dtype
        self._device = like.device

    def __call__(self, coefficients: WaveletCoeffNd) -> torch.Tensor:
        """Reconstruct the volume from 3d boundary-wavelet coefficients."""
        for coeff_dict in coefficients[1:]:
            if not isinstance(coeff_dict, dict) or len(coeff_dict) != 7:
                raise ValueError(invalid_coeffs_message("7-entry detail dict", coeff_dict))
        coeffs = coeff_tree_map(as_device_tensor, coefficients)
        _check_dtype(coeffs[0].dtype)
        coeffs, ds = preprocess_coeffs(coeffs, ndim=3, axes=self.axes)
        shapes = [tuple(2 * s for s in level["ddd"].shape[-3:]) for level in coeffs[1:]]
        ref = coeffs[0]
        if self._built_shapes != shapes or self._dtype != ref.dtype or self._device != ref.device:
            self._build(shapes, ref)

        res = coeffs[0]
        for c_pos, level_dict in enumerate(coeffs[1:]):
            n_d, n_h, n_w = level_dict["ddd"].shape[-3:]
            res = res[..., :n_d, :n_h, :n_w]
            # the packed level: each axis's lo half, then its hi half
            blocks = {(0, 0, 0): res}
            blocks.update({sel: level_dict[key] for sel, key in zip(SUBBAND_ORDERS[3][1:], _DETAIL_KEYS_3D)})
            res = torch.cat(
                [
                    torch.cat(
                        [torch.cat([blocks[(d, h, 0)], blocks[(d, h, 1)]], -1) for h in (0, 1)], -2
                    )
                    for d in (0, 1)
                ],
                -3,
            )
            for axis, op in zip((-3, -2, -1), self.ifwt_matrix_list[c_pos]):
                res = _apply_axis(res, op, axis)
        return postprocess_tensor(res, ndim=3, ds=ds, axes=self.axes)
