"""1d boundary-wavelet transforms as dense matrix products.

Counterpart of :mod:`ptwt_tpu.matmul_transform`.  The per-level orthogonal
boundary operators are built on the host (:mod:`.ops._boundary`) once per
(length, level, dtype, device) and kept as tensors on the input's device,
so a call makes no host-to-device copy; they are rebuilt when any of the
four changes.  A level up to :func:`~.ops.long_boundary_cutoff` samples
is one dense product; a longer one runs the O(n) banded apply
(:class:`~.ops._boundary_long.LongAnalysisOp`: K3 or K4 on the card), and
up to four long levels of an exactly halving chain on an axis longer than
``2**16`` run fused (:class:`~.ops._boundary_long.LongAnalysisRun`: one
K8a launch, one K8b launch back).  Every product runs at
:func:`~.ops.get_precision` (full float32 by default).
"""

from __future__ import annotations

import sys
import warnings
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .constants import OrthogonalizeMethod, Wavelet
from .conv_transform import _check_dtype
from .ops._boundary import (
    boundary_analysis_matrix,
    boundary_synthesis_matrix,
    chain_fused_operator,
    orthogonalize_rows,
)
from .ops._boundary_long import (
    LongAnalysisOp,
    LongAnalysisRun,
    LongSynthesisOp,
    LongSynthesisRun,
    long_boundary_cutoff,
    long_run_depth,
    long_supported,
    long_syn_run_depth,
)
from .ops._conv import axis_matmul
from .ops._library import constant_tensor
from .sparse_math import DeviceArg, _tensor
from .utils import (
    as_device_tensor,
    deprecated_alias,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
)
from .wavelets import Wavelet as RegistryWavelet
from .wavelets import dwt_max_level

__all__ = [
    "MatrixWavedec",
    "MatrixWaverec",
    "construct_boundary_a",
    "construct_boundary_s",
    "orthogonalize",
]


def orthogonalize(matrix, filt_len: int, method: OrthogonalizeMethod = "qr") -> torch.Tensor:
    """Re-orthonormalize the deficient boundary rows of a wavelet matrix
    (float64, on ``matrix``'s device)."""
    host = matrix.detach().cpu().numpy() if isinstance(matrix, torch.Tensor) else np.asarray(matrix)
    return _tensor(orthogonalize_rows(np.asarray(host, dtype=np.float64), filt_len, method), None, matrix)


@deprecated_alias(boundary="orthogonalization")
def construct_boundary_a(
    wavelet: Union[Wavelet, str],
    length: int,
    *,
    orthogonalization: OrthogonalizeMethod = "qr",
    dtype: torch.dtype = torch.float64,
    device: DeviceArg = None,
) -> torch.Tensor:
    """Construct the orthogonal boundary-wavelet analysis matrix."""
    return _tensor(boundary_analysis_matrix(wavelet, length, orthogonalization), device).to(dtype)


@deprecated_alias(boundary="orthogonalization")
def construct_boundary_s(
    wavelet: Union[Wavelet, str],
    length: int,
    *,
    orthogonalization: OrthogonalizeMethod = "qr",
    dtype: torch.dtype = torch.float64,
    device: DeviceArg = None,
) -> torch.Tensor:
    """Construct the orthogonal boundary-wavelet synthesis matrix."""
    return _tensor(boundary_synthesis_matrix(wavelet, length, orthogonalization), device).to(dtype)


def _as_wavelet_obj(wavelet) -> Wavelet:
    if isinstance(wavelet, str):
        return RegistryWavelet(wavelet)
    if any(isinstance(f, torch.Tensor) and f.requires_grad for f in getattr(wavelet, "filter_bank", ())):
        # ptwt_tpu builds these operators with np.asarray too, and refuses a
        # traced bank there (TracerArrayConversionError, a TypeError)
        raise TypeError(
            "the matrix transforms build their operators on the host from constant "
            "filters and give no filter gradient: pass a bank that does not require "
            "grad (e.g. tuple(f.detach() for f in bank.filter_bank)), or train the "
            "bank through wavedec/wavedec2/wavedec3 or the packet trees' padded modes"
        )
    return wavelet


def _check_orthogonal(wavelet) -> None:
    if not getattr(wavelet, "orthogonal", True):
        warnings.warn(
            "Matrix transforms rely on QR boundary orthogonalization, which "
            "assumes an orthogonal wavelet; results for biorthogonal "
            "wavelets are approximations."
        )


def _plan_levels(length: int, level: Optional[int], filt_len: int) -> tuple[int, list[int]]:
    """Per-level (even) input lengths, clamping the level like the
    reference: ``(level, lengths)``, ``lengths[k]`` the even input length
    the level-k matrix is built for."""
    if level is None:
        level = dwt_max_level(length, filt_len)
    lengths = []
    curr = length + (length % 2)
    for lvl in range(level):
        if curr < filt_len:
            sys.stderr.write(
                f"Warning: signal length {curr} too short for filter "
                f"({filt_len}); clamping to {lvl} levels.\n"
            )
            level = lvl
            break
        lengths.append(curr)
        curr = curr // 2
        curr += curr % 2
    return level, lengths


def _operator(matrix: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host operator on ``like``'s device and dtype, kept by the caller."""
    return constant_tensor(torch.as_tensor(matrix, dtype=like.dtype, device=like.device))


@torch.compiler.assume_constant_result
def _dense_operator(wavelet, length: int, method: str, synthesis: bool) -> np.ndarray:
    """A boundary operator built on the host in float64 from the wavelet's
    own filters: a compiled transform takes it as a constant (guarded on
    the wavelet object's identity), as ``jax.jit`` takes the JAX
    package's numpy operators.  The transform objects keep what it
    returns, so it is not cached here."""
    build = boundary_synthesis_matrix if synthesis else boundary_analysis_matrix
    return build(wavelet, length, method)


def _boundary_operator(wavelet, length: int, method: str, synthesis: bool, like: torch.Tensor) -> torch.Tensor:
    """The ``length`` boundary analysis (synthesis) operator of ``wavelet``
    on ``like``'s device and dtype."""
    return _operator(_dense_operator(wavelet, length, method, synthesis), like)


def _host64(matrix) -> np.ndarray:
    return matrix.detach().cpu().numpy().astype(np.float64)


class BaseMatrixWaveDec:
    """Common base for matrix wavelet decompositions."""


class MatrixWavedec(BaseMatrixWaveDec):
    """Boundary-wavelet analysis transform (1d).

    A stateful callable: the per-level orthogonal operators are built on
    the first call and kept until the input length, level, dtype or
    device changes.

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.matmul_transform import MatrixWavedec
        >>> coeffs = MatrixWavedec("haar", level=2)(torch.arange(16.0))
        >>> [int(c.shape[-1]) for c in coeffs]
        [4, 4, 8]
    """

    @deprecated_alias(boundary="orthogonalization")
    def __init__(
        self,
        wavelet: Union[Wavelet, str],
        level: Optional[int] = None,
        *,
        axis: int = -1,
        orthogonalization: OrthogonalizeMethod = "qr",
        odd_coeff_padding_mode: str = "zero",
    ):
        self.wavelet = _as_wavelet_obj(wavelet)
        _check_orthogonal(self.wavelet)
        self.level = level
        self.axis = axis
        self.orthogonalization = orthogonalization
        self.odd_coeff_padding_mode = odd_coeff_padding_mode
        self.input_length: Optional[int] = None
        self.fwt_matrix_list: list = []
        self._runs: dict[int, LongAnalysisRun] = {}
        self._level_lengths: list[int] = []
        self._built_level: Optional[int] = None
        self._dtype = None
        self._device = None

    @property
    def sparse_fwt_operator(self) -> torch.Tensor:
        """Fused single-matrix analysis operator (pad-free case only), a
        dense float64 tensor on the device of the last call."""
        if not self.fwt_matrix_list:
            raise ValueError("Call the transform on data first to build it.")
        # pad-free chain only: padding happens when the input is odd or any
        # level's ll length is odd (the next entry is evenized)
        lengths = self._level_lengths
        padded_chain = (self.input_length is not None and self.input_length != lengths[0]) or any(
            lengths[k] != 2 * lengths[k + 1] for k in range(len(lengths) - 1)
        )
        if padded_chain:
            raise NotImplementedError(
                "The fused operator requires a pad-free (exactly halving) "
                "length chain on every level."
            )
        if any(isinstance(m, LongAnalysisOp) for m in self.fwt_matrix_list):
            raise NotImplementedError(
                "The fused operator cannot be materialized beyond the "
                "long-signal cutoff (the banded O(n) apply has no dense "
                "matrix form); see ops.set_long_boundary_cutoff."
            )
        fused = chain_fused_operator([_host64(m) for m in self.fwt_matrix_list])
        return torch.as_tensor(fused, device=self._device)

    @property
    def fwt_operator(self) -> torch.Tensor:
        """Alias of :attr:`sparse_fwt_operator`."""
        return self.sparse_fwt_operator

    def _build(self, length: int, like: torch.Tensor) -> None:
        filt_len = self.wavelet.dec_len
        level, lengths = _plan_levels(length, self.level, filt_len)
        self._built_level = level
        self._level_lengths = lengths
        cutoff = long_boundary_cutoff()
        self.fwt_matrix_list = [
            LongAnalysisOp(self.wavelet, lvl_len, self.orthogonalization)
            if lvl_len > cutoff and long_supported(self.wavelet, lvl_len, self.orthogonalization)
            else _boundary_operator(self.wavelet, lvl_len, self.orthogonalization, False, like)
            for lvl_len in lengths
        ]
        # fuse maximal runs of consecutive long levels (exactly halving
        # chains) into single K8a launches
        self._runs = {}
        idx = 0
        while idx < len(lengths):
            if isinstance(self.fwt_matrix_list[idx], LongAnalysisOp):
                depth = long_run_depth(self.wavelet, tuple(lengths[idx:]), self.orthogonalization, like.dtype)
                if depth >= 2:
                    try:
                        self._runs[idx] = LongAnalysisRun(
                            self.wavelet, lengths[idx : idx + depth], self.orthogonalization
                        )
                        idx += depth
                        continue
                    except ValueError:
                        pass
            idx += 1

    def __call__(self, input_signal) -> list[torch.Tensor]:
        """Compute the boundary-wavelet coefficients ``[cA_n, cD_n, ...]``."""
        data = as_device_tensor(input_signal)
        _check_dtype(data.dtype)
        data, ds = preprocess_tensor(data, ndim=1, axes=self.axis)
        length = data.shape[-1]
        if (
            self.input_length != length
            or self._built_level is None
            or self._dtype != data.dtype
            or self._device != data.device
        ):
            self._build(length, data)
            self.input_length = length
            self._dtype = data.dtype
            self._device = data.device

        result: list[torch.Tensor] = []
        res_lo = data
        idx = 0
        while idx < len(self.fwt_matrix_list):
            if res_lo.shape[-1] % 2:
                if self.odd_coeff_padding_mode == "zero":
                    res_lo = F.pad(res_lo, (0, 1))
                else:
                    res_lo = torch.cat([res_lo, res_lo[..., -1:]], -1)
            run = self._runs.get(idx)
            if run is not None:
                res_lo, his = run.apply(res_lo)
                result.extend(his)
                idx += run.depth
                continue
            matrix = self.fwt_matrix_list[idx]
            if isinstance(matrix, LongAnalysisOp):
                coeffs = matrix.apply(res_lo)
            else:
                coeffs = axis_matmul(res_lo, matrix, -1)
            split = coeffs.shape[-1] // 2
            res_lo = coeffs[..., :split]
            result.append(coeffs[..., split:])
            idx += 1
        result.append(res_lo)
        result.reverse()
        return postprocess_coeffs(result, ndim=1, ds=ds, axes=self.axis)


class MatrixWaverec:
    """Inverse of :class:`MatrixWavedec` (1d boundary-wavelet synthesis).

    Example:
        >>> import torch
        >>> from ptwt_tpu_torch.matmul_transform import MatrixWavedec, MatrixWaverec
        >>> x = torch.arange(16.0)
        >>> rec = MatrixWaverec("db2")(MatrixWavedec("db2", level=2)(x))
        >>> bool(torch.allclose(rec, x, atol=1e-5))
        True
    """

    @deprecated_alias(boundary="orthogonalization")
    def __init__(
        self,
        wavelet: Union[Wavelet, str],
        *,
        axis: int = -1,
        orthogonalization: OrthogonalizeMethod = "qr",
    ):
        self.wavelet = _as_wavelet_obj(wavelet)
        _check_orthogonal(self.wavelet)
        self.axis = axis
        self.orthogonalization = orthogonalization
        self.ifwt_matrix_list: list = []
        self._built_lengths: list[int] = []
        self._dtype = None
        self._device = None
        self._syn_run = None

    @property
    def sparse_ifwt_operator(self) -> torch.Tensor:
        """Fused single-matrix synthesis operator (pad-free case only), a
        dense float64 tensor on the device of the last call."""
        if not self.ifwt_matrix_list:
            raise ValueError("Call the transform on coefficients first.")
        # pad-free chain only (coarse to fine: each level's output length
        # must equal the next operator's coefficient-pair half-length)
        lengths = self._built_lengths
        if any(lengths[k + 1] != 2 * lengths[k] for k in range(len(lengths) - 1)):
            raise NotImplementedError(
                "The fused operator requires a pad-free (exactly doubling) "
                "length chain on every level."
            )
        if any(isinstance(m, LongSynthesisOp) for m in self.ifwt_matrix_list):
            raise NotImplementedError(
                "The fused operator cannot be materialized beyond the "
                "long-signal cutoff (the banded O(n) apply has no dense "
                "matrix form); see ops.set_long_boundary_cutoff."
            )
        # ifwt_matrix_list is ordered coarse to fine, the application order
        fused = chain_fused_operator([_host64(m) for m in self.ifwt_matrix_list])
        return torch.as_tensor(fused, device=self._device)

    @property
    def ifwt_operator(self) -> torch.Tensor:
        """Alias of :attr:`sparse_ifwt_operator`."""
        return self.sparse_ifwt_operator

    def _build(self, lengths: list[int], like: torch.Tensor) -> None:
        cutoff = long_boundary_cutoff()
        self.ifwt_matrix_list = [
            LongSynthesisOp(self.wavelet, length, self.orthogonalization)
            if length > cutoff and long_supported(self.wavelet, length, self.orthogonalization)
            else _boundary_operator(self.wavelet, length, self.orthogonalization, True, like)
            for length in lengths
        ]
        self._built_lengths = lengths
        self._dtype = like.dtype
        self._device = like.device
        # fuse the final (long) steps of an exactly doubling chain into one
        # K8b launch
        self._syn_run = None
        depth = long_syn_run_depth(self.wavelet, tuple(lengths), self.orthogonalization, like.dtype)
        if depth >= 2:
            try:
                self._syn_run = (
                    len(lengths) - depth,
                    LongSynthesisRun(self.wavelet, lengths[-depth:], self.orthogonalization),
                )
            except ValueError:
                pass

    def __call__(self, coefficients) -> torch.Tensor:
        """Reconstruct the signal from ``[cA_n, cD_n, ..., cD_1]``."""
        coeffs = [as_device_tensor(c) for c in coefficients]
        _check_dtype(coeffs[0].dtype)
        coeffs, ds = preprocess_coeffs(coeffs, ndim=1, axes=self.axis)
        # synthesis matrix sizes: twice each detail length, coarse to fine
        lengths = [2 * c.shape[-1] for c in coeffs[1:]]
        ref = coeffs[0]
        if self._built_lengths != lengths or self._dtype != ref.dtype or self._device != ref.device:
            self._build(lengths, ref)

        res_lo = coeffs[0]
        for c_pos, res_hi in enumerate(coeffs[1:]):
            if res_lo.shape[-1] != res_hi.shape[-1]:
                # the analysis padded an odd cA by one: crop the extra sample
                if res_lo.shape[-1] == res_hi.shape[-1] + 1:
                    res_lo = res_lo[..., :-1]
                else:
                    raise ValueError("coefficients on each level must have matching shapes")
            if self._syn_run is not None and c_pos == self._syn_run[0]:
                res_lo = self._syn_run[1].apply(res_lo, coeffs[c_pos + 1 :])
                break
            op = self.ifwt_matrix_list[c_pos]
            if isinstance(op, LongSynthesisOp):
                res_lo = op.apply_pair(res_lo, res_hi)
            else:
                res_lo = axis_matmul(torch.cat([res_lo, res_hi], -1), op, -1)
        return postprocess_tensor(res_lo, ndim=1, ds=ds, axes=self.axis)
