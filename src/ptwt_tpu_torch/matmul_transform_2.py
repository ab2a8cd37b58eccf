"""2d boundary-wavelet transforms as dense matrix products.

Counterpart of :mod:`ptwt_tpu.matmul_transform_2`.  Two backends:

- ``separable=True`` (default): the per-axis 1d boundary operators applied
  as two products per level, ``A_h X A_w^T``;
- ``separable=False``: the explicit 2d operator, in two constructions
  chosen by ``nonseparable=``:

  * ``"kron"`` (default): the Kronecker product of the orthogonal 1d
    operators.  ``kron(A_w, A_h) vec(X) == vec(A_h X A_w^T)``, so it is
    applied factored, as the separable backend is; the explicit
    ``[hw, hw]`` matrix is only built by ``sparse_fwt_operator``;
  * ``"reference"``: the reference's literal construction, strided 2d
    convolution matrices whose ``dec_len**2``-deficient boundary rows are
    re-orthogonalized, for bit-compatibility with stored coefficients.

A long axis (past :func:`~.ops.long_boundary_cutoff`) of the separable and
``kron`` backends runs the O(n) banded apply along its own axis (K3 and
K4 on the card, ``axis=-2`` or ``-1``).  Every product runs at
:func:`~.ops.get_precision`.  Coefficients are ``(cA, (H, V, D), ...)``
with H the high pass on rows, as :func:`ptwt_tpu_torch.wavedec2` gives them.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .constants import OrthogonalizeMethod, Wavelet, WaveletCoeff2d, WaveletDetailTuple2d
from .conv_transform import _check_dtype
from .matmul_transform import (
    BaseMatrixWaveDec,
    _as_wavelet_obj,
    _check_orthogonal,
    _host64,
    _operator,
    _plan_levels,
)
from .ops._boundary import (
    boundary_analysis_matrix,
    boundary_synthesis_matrix,
    chain_fused_operator,
    orthogonalize_rows,
)
from .ops._boundary_long import LongAnalysisOp, LongSynthesisOp, long_boundary_cutoff, long_supported
from .ops._conv import axis_matmul
from .sparse_math import DeviceArg, _strided_conv2d_matrix_np, _tensor
from .utils import (
    as_device_tensor,
    coeff_tree_map,
    deprecated_alias,
    invalid_coeffs_message,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)

__all__ = [
    "MatrixWavedec2",
    "MatrixWaverec2",
    "construct_boundary_a2",
    "construct_boundary_s2",
]


def _kron_analysis_2d(a_h: np.ndarray, a_w: np.ndarray) -> np.ndarray:
    """Stack the four subband blocks of the non-separable 2d operator.

    Column-major image flattening: ``vec(A_h X A_w^T) = kron(A_w, A_h)
    vec(X)``.  Block order (ll, lh, hl, hh) with lh the high pass on rows.
    """
    n_h, n_w = a_h.shape[0] // 2, a_w.shape[0] // 2
    h_lo, h_hi = a_h[:n_h], a_h[n_h:]
    w_lo, w_hi = a_w[:n_w], a_w[n_w:]
    return np.concatenate(
        [np.kron(w_lo, h_lo), np.kron(w_lo, h_hi), np.kron(w_hi, h_lo), np.kron(w_hi, h_hi)],
        axis=0,
    )


def _reference_2d_np(filters, height: int, width: int, method: str) -> np.ndarray:
    """Strided ``sameshift`` 2d convolution matrices of the four outer
    product filters (column-major vec, order ll, lh, hl, hh), with the rows
    carrying fewer than ``L**2`` entries re-orthogonalized."""
    lo, hi = filters
    blocks = [
        _strided_conv2d_matrix_np(np.outer(f_r, f_c), height, width, 2, "sameshift")
        for f_r, f_c in ((lo, lo), (hi, lo), (lo, hi), (hi, hi))
    ]
    return orthogonalize_rows(np.concatenate(blocks, axis=0), len(lo) ** 2, method)


def _reference_a2_np(wavelet, height: int, width: int, method: str = "qr") -> np.ndarray:
    """The reference's literal non-separable analysis operator."""
    wavelet = _as_wavelet_obj(wavelet)
    filters = [np.asarray(f, dtype=np.float64) for f in (wavelet.dec_lo, wavelet.dec_hi)]
    return _reference_2d_np(filters, height, width, method)


def _reference_s2_np(wavelet, height: int, width: int, method: str = "qr") -> np.ndarray:
    """The reference's literal non-separable synthesis operator: built from
    the flipped reconstruction filters and transposed."""
    wavelet = _as_wavelet_obj(wavelet)
    filters = [np.asarray(f, dtype=np.float64)[::-1] for f in (wavelet.rec_lo, wavelet.rec_hi)]
    return _reference_2d_np(filters, height, width, method).T


def construct_boundary_a2(
    wavelet: Union[Wavelet, str],
    height: int,
    width: int,
    *,
    orthogonalization: OrthogonalizeMethod = "qr",
    dtype: torch.dtype = torch.float64,
    device: DeviceArg = None,
) -> torch.Tensor:
    """Orthogonal non-separable 2d analysis operator (column-major vec)."""
    a_h = boundary_analysis_matrix(wavelet, height, orthogonalization)
    a_w = boundary_analysis_matrix(wavelet, width, orthogonalization)
    return _tensor(_kron_analysis_2d(a_h, a_w), device).to(dtype)


def construct_boundary_s2(
    wavelet: Union[Wavelet, str],
    height: int,
    width: int,
    *,
    orthogonalization: OrthogonalizeMethod = "qr",
    dtype: torch.dtype = torch.float64,
    device: DeviceArg = None,
) -> torch.Tensor:
    """Orthogonal non-separable 2d synthesis operator (column-major vec)."""
    s_h = boundary_synthesis_matrix(wavelet, height, orthogonalization)
    s_w = boundary_synthesis_matrix(wavelet, width, orthogonalization)
    return _tensor(_kron_analysis_2d(s_h.T, s_w.T).T, device).to(dtype)


def _check_padfree_2d_chain(input_shape, op_in_sizes) -> None:
    """Raise unless the per-level operator sizes form a pad-free chain:
    every level's ``ll`` quarter feeds the next operator unchanged and the
    image was not odd-padded."""
    sizes = list(op_in_sizes)
    fine_to_coarse = (
        sizes if all(sizes[k] == 4 * sizes[k + 1] for k in range(len(sizes) - 1)) else sizes[::-1]
    )
    ok = all(fine_to_coarse[k] == 4 * fine_to_coarse[k + 1] for k in range(len(fine_to_coarse) - 1))
    if ok and input_shape is not None:
        ok = input_shape[0] * input_shape[1] == fine_to_coarse[0]
    if not ok:
        raise NotImplementedError(
            "The fused operator requires a pad-free (exactly quartering) "
            "level chain; this decomposition pads odd lengths."
        )


def _pad_odd_axes(data: torch.Tensor, axes) -> torch.Tensor:
    """Zero-pad each odd axis of ``axes`` (negative) by one sample at its end."""
    pad = [0] * (2 * max(-a for a in axes))
    for ax in axes:
        if data.shape[ax] % 2:
            pad[2 * (-ax - 1) + 1] = 1
    return F.pad(data, pad) if any(pad) else data


def _apply_axis(x: torch.Tensor, op, axis: int) -> torch.Tensor:
    """One 1d operator along ``axis``: the banded apply for a long op, a
    dense product otherwise."""
    if isinstance(op, (LongAnalysisOp, LongSynthesisOp)):
        return op.apply(x, axis)
    return axis_matmul(x, op, axis)


class MatrixWavedec2(BaseMatrixWaveDec):
    """2d boundary-wavelet analysis through cached dense operators.

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.matmul_transform_2 import MatrixWavedec2
        >>> cA, (H1, V1, D1) = MatrixWavedec2("db2", level=1)(torch.ones(4, 32, 32))
        >>> tuple(cA.shape)
        (4, 16, 16)
    """

    @deprecated_alias(boundary="orthogonalization")
    def __init__(
        self,
        wavelet: Union[Wavelet, str],
        level: Optional[int] = None,
        *,
        axes: tuple[int, int] = (-2, -1),
        separable: bool = True,
        orthogonalization: OrthogonalizeMethod = "qr",
        odd_coeff_padding_mode: str = "zero",
        nonseparable: str = "kron",
    ):
        self.wavelet = _as_wavelet_obj(wavelet)
        _check_orthogonal(self.wavelet)
        self.level = level
        self.axes = axes
        self.separable = separable
        self.orthogonalization = orthogonalization
        self.odd_coeff_padding_mode = odd_coeff_padding_mode
        if nonseparable not in ("kron", "reference"):
            raise ValueError(f"nonseparable must be 'kron' or 'reference', got {nonseparable!r}")
        self.nonseparable = nonseparable
        self.input_signal_shape: Optional[tuple[int, int]] = None
        self.fwt_matrix_list: list = []
        self._level_shapes: list = []
        self._dtype = None
        self._device = None
        self._built_level: Optional[int] = None

    @property
    def _factored(self) -> bool:
        return self.separable or self.nonseparable == "kron"

    @property
    def sparse_fwt_operator(self) -> torch.Tensor:
        """Fused single-matrix analysis operator (non-separable, pad-free):
        each level's ``[hw, hw]`` operator acts on the ``ll`` prefix of the
        column-major coefficient vector while an identity passes the
        details through.  A dense float64 tensor."""
        if not self.fwt_matrix_list:
            raise ValueError("Call the transform on data first to build it.")
        if self.separable:
            raise NotImplementedError("The fused operator requires separable=False.")
        if self.nonseparable == "kron":
            # the apply never materializes the kron operator: build the
            # explicit per-level [hw, hw] matrices here
            _check_padfree_2d_chain(self.input_signal_shape, [h * w for h, w in self._level_shapes])
            mats = [
                _kron_analysis_2d(
                    boundary_analysis_matrix(self.wavelet, h, self.orthogonalization),
                    boundary_analysis_matrix(self.wavelet, w, self.orthogonalization),
                )
                for h, w in self._level_shapes
            ]
        else:
            _check_padfree_2d_chain(self.input_signal_shape, [int(m.shape[1]) for m in self.fwt_matrix_list])
            mats = [_host64(m) for m in self.fwt_matrix_list]
        return torch.as_tensor(chain_fused_operator(mats), device=self._device)

    @property
    def fwt_operator(self) -> torch.Tensor:
        """Alias of :attr:`sparse_fwt_operator`."""
        return self.sparse_fwt_operator

    def _build(self, height: int, width: int, like: torch.Tensor) -> None:
        filt_len = self.wavelet.dec_len
        level_h, lengths_h = _plan_levels(height, self.level, filt_len)
        level_w, lengths_w = _plan_levels(width, self.level, filt_len)
        level = min(level_h, level_w)
        if self.level is not None and level < self.level:
            warnings.warn(
                f"Signal shape ({height}, {width}) supports only {level} "
                f"levels for this wavelet; clamping from {self.level}."
            )
        self._built_level = level
        cutoff = long_boundary_cutoff()

        def axis_op(length):
            if self._factored and length > cutoff and long_supported(self.wavelet, length, self.orthogonalization):
                return LongAnalysisOp(self.wavelet, length, self.orthogonalization)
            return _operator(boundary_analysis_matrix(self.wavelet, length, self.orthogonalization), like)

        self.fwt_matrix_list = [
            (axis_op(lengths_h[lvl]), axis_op(lengths_w[lvl]))
            if self._factored
            else _operator(
                _reference_a2_np(self.wavelet, lengths_h[lvl], lengths_w[lvl], self.orthogonalization), like
            )
            for lvl in range(level)
        ]
        self._level_shapes = [(lengths_h[lvl], lengths_w[lvl]) for lvl in range(level)]

    def __call__(self, input_signal) -> WaveletCoeff2d:
        """Compute the 2d boundary-wavelet coefficients."""
        data = as_device_tensor(input_signal)
        _check_dtype(data.dtype)
        data, ds = preprocess_tensor(data, ndim=2, axes=self.axes)
        shape = (data.shape[-2], data.shape[-1])
        if (
            self.input_signal_shape != shape
            or self._built_level is None
            or self._dtype != data.dtype
            or self._device != data.device
        ):
            self._build(*shape, data)
            self.input_signal_shape = shape
            self._dtype = data.dtype
            self._device = data.device

        result_lst: list[WaveletDetailTuple2d] = []
        res_ll = data
        for matrices in self.fwt_matrix_list:
            res_ll = _pad_odd_axes(res_ll, (-2, -1))
            if self._factored:
                a_h, a_w = matrices
                coeffs = _apply_axis(_apply_axis(res_ll, a_h, -2), a_w, -1)
                n_h, n_w = a_h.shape[0] // 2, a_w.shape[0] // 2
                res_ll = coeffs[:, :n_h, :n_w]
                detail = WaveletDetailTuple2d(
                    coeffs[:, n_h:, :n_w],  # H: high pass on rows
                    coeffs[:, :n_h, n_w:],  # V: high pass on columns
                    coeffs[:, n_h:, n_w:],  # D
                )
            else:
                batch, height, width = res_ll.shape
                flat = res_ll.transpose(1, 2).reshape(batch, height * width)  # column-major vec
                coeffs = axis_matmul(flat, matrices, -1)
                quarter = coeffs.shape[-1] // 4
                n_h, n_w = height // 2, width // 2

                def unvec(block):
                    return block.reshape(batch, n_w, n_h).transpose(1, 2)

                res_ll = unvec(coeffs[..., :quarter])
                detail = WaveletDetailTuple2d(
                    unvec(coeffs[..., quarter : 2 * quarter]),
                    unvec(coeffs[..., 2 * quarter : 3 * quarter]),
                    unvec(coeffs[..., 3 * quarter :]),
                )
            result_lst.append(detail)

        result_lst.reverse()
        result: WaveletCoeff2d = (res_ll, *result_lst)
        return postprocess_coeffs(result, ndim=2, ds=ds, axes=self.axes)


class MatrixWaverec2:
    """Inverse of :class:`MatrixWavedec2`.

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.matmul_transform_2 import MatrixWavedec2, MatrixWaverec2
        >>> img = torch.ones(2, 32, 32)
        >>> rec = MatrixWaverec2("db2")(MatrixWavedec2("db2", level=2)(img))
        >>> bool(torch.allclose(rec, img, atol=1e-5))
        True
    """

    @deprecated_alias(boundary="orthogonalization")
    def __init__(
        self,
        wavelet: Union[Wavelet, str],
        *,
        axes: tuple[int, int] = (-2, -1),
        separable: bool = True,
        orthogonalization: OrthogonalizeMethod = "qr",
        nonseparable: str = "kron",
    ):
        self.wavelet = _as_wavelet_obj(wavelet)
        _check_orthogonal(self.wavelet)
        self.axes = axes
        self.separable = separable
        self.orthogonalization = orthogonalization
        if nonseparable not in ("kron", "reference"):
            raise ValueError(f"nonseparable must be 'kron' or 'reference', got {nonseparable!r}")
        self.nonseparable = nonseparable
        self.ifwt_matrix_list: list = []
        self._built_shapes: list = []
        self._dtype = None
        self._device = None

    @property
    def _factored(self) -> bool:
        return self.separable or self.nonseparable == "kron"

    @property
    def sparse_ifwt_operator(self) -> torch.Tensor:
        """Fused single-matrix synthesis operator (non-separable, pad-free),
        a dense float64 tensor."""
        if not self.ifwt_matrix_list:
            raise ValueError("Call the transform on coefficients first.")
        if self.separable:
            raise NotImplementedError("The fused operator requires separable=False.")
        if self.nonseparable == "kron":
            _check_padfree_2d_chain(None, [h * w for h, w in self._built_shapes])
            mats = [
                _kron_analysis_2d(
                    boundary_synthesis_matrix(self.wavelet, h, self.orthogonalization).T,
                    boundary_synthesis_matrix(self.wavelet, w, self.orthogonalization).T,
                ).T
                for h, w in self._built_shapes
            ]
        else:
            _check_padfree_2d_chain(None, [int(m.shape[1]) for m in self.ifwt_matrix_list])
            mats = [_host64(m) for m in self.ifwt_matrix_list]
        return torch.as_tensor(chain_fused_operator(mats), device=self._device)

    @property
    def ifwt_operator(self) -> torch.Tensor:
        """Alias of :attr:`sparse_ifwt_operator`."""
        return self.sparse_ifwt_operator

    def _build(self, shapes: list[tuple[int, int]], like: torch.Tensor) -> None:
        cutoff = long_boundary_cutoff()

        def axis_op(length):
            if self._factored and length > cutoff and long_supported(self.wavelet, length, self.orthogonalization):
                return LongSynthesisOp(self.wavelet, length, self.orthogonalization)
            return _operator(boundary_synthesis_matrix(self.wavelet, length, self.orthogonalization), like)

        self.ifwt_matrix_list = [
            (axis_op(height), axis_op(width))
            if self._factored
            else _operator(_reference_s2_np(self.wavelet, height, width, self.orthogonalization), like)
            for height, width in shapes
        ]
        self._built_shapes = shapes
        self._dtype = like.dtype
        self._device = like.device

    def __call__(self, coefficients: WaveletCoeff2d) -> torch.Tensor:
        """Reconstruct the image from 2d boundary-wavelet coefficients."""
        for coeff_tuple in coefficients[1:]:
            if not isinstance(coeff_tuple, tuple) or len(coeff_tuple) != 3:
                raise ValueError(invalid_coeffs_message("3-tuple of arrays", coeff_tuple))
        coeffs = coeff_tree_map(as_device_tensor, coefficients)
        _check_dtype(coeffs[0].dtype)
        coeffs, ds = preprocess_coeffs(coeffs, ndim=2, axes=self.axes)
        shapes = [(2 * t[0].shape[-2], 2 * t[0].shape[-1]) for t in coeffs[1:]]
        ref = coeffs[0]
        if self._built_shapes != shapes or self._dtype != ref.dtype or self._device != ref.device:
            self._build(shapes, ref)

        res_ll = coeffs[0]
        for c_pos, (h, v, d) in enumerate(coeffs[1:]):
            # crop the odd-length padding of a deeper reconstruction
            res_ll = res_ll[..., : h.shape[-2], : h.shape[-1]]
            if self._factored:
                s_h, s_w = self.ifwt_matrix_list[c_pos]
                stacked = torch.cat([torch.cat([res_ll, h], -2), torch.cat([v, d], -2)], -1)
                res_ll = _apply_axis(_apply_axis(stacked, s_h, -2), s_w, -1)
            else:
                batch = res_ll.shape[0]

                def vec(block):
                    return block.transpose(1, 2).reshape(batch, block.shape[-2] * block.shape[-1])

                flat = torch.cat([vec(res_ll), vec(h), vec(v), vec(d)], -1)
                out = axis_matmul(flat, self.ifwt_matrix_list[c_pos], -1)
                height, width = 2 * res_ll.shape[-2], 2 * res_ll.shape[-1]
                res_ll = out.reshape(batch, width, height).transpose(1, 2)
        return postprocess_tensor(res_ll, ndim=2, ds=ds, axes=self.axes)
