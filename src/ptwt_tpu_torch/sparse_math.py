"""Operator-algebra helpers, as dense tensors.

Counterpart of :mod:`ptwt_tpu.sparse_math`, which returns dense arrays
under the reference's function names.  So does this module: the banded
wavelet operators are built on the host in float64 (:mod:`.ops._boundary`)
and returned as dense float64 tensors.  A constructor given a tensor returns
its result on that tensor's device; otherwise on ``device``, and with no
``device`` on the CUDA device, as every entry point of the package does.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .ops._boundary import conv_matrix as _conv_matrix_np
from .ops._boundary import strided_conv_matrix as _strided_conv_matrix_np
from .ops._conv import axis_matmul
from .utils import as_device_tensor

__all__ = [
    "construct_conv_matrix",
    "construct_strided_conv_matrix",
    "construct_conv2d_matrix",
    "construct_strided_conv2d_matrix",
    "sparse_kron",
    "cat_sparse_identity_matrix",
    "batch_mm",
]

DeviceArg = Optional[Union[str, torch.device]]


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _tensor(arr: np.ndarray, device: DeviceArg, *like) -> torch.Tensor:
    """``arr`` as a tensor on ``device``, else on the device of the first
    tensor in ``like``, else on the CUDA device."""
    if device is None:
        for t in like:
            if isinstance(t, torch.Tensor):
                device = t.device
                break
    if device is None:
        return as_device_tensor(arr)
    return torch.as_tensor(arr, device=device)


def construct_conv_matrix(
    filt, input_rows: int, *, mode: str = "valid", device: DeviceArg = None
) -> torch.Tensor:
    """Dense 1d convolution matrix: ``C @ x == conv(x, filt, mode)``."""
    return _tensor(_conv_matrix_np(_host(filt), input_rows, mode), device, filt)


def construct_strided_conv_matrix(
    filt, input_rows: int, stride: int = 2, *, mode: str = "valid", device: DeviceArg = None
) -> torch.Tensor:
    """Dense strided convolution matrix (``sameshift`` keeps rows
    ``1::stride``)."""
    return _tensor(_strided_conv_matrix_np(_host(filt), input_rows, stride, mode), device, filt)


def _conv2d_matrix_np(filt: np.ndarray, input_rows: int, input_columns: int, mode: str) -> np.ndarray:
    row_blocks = [_conv_matrix_np(filt[:, i], input_rows, mode) for i in range(filt.shape[-1])]
    col_selector = _conv_matrix_np(np.ones(filt.shape[-1]), input_columns, mode)
    total = np.zeros((row_blocks[0].shape[0] * col_selector.shape[0], input_rows * input_columns))
    for i, block in enumerate(row_blocks):
        column_pattern = _conv_matrix_np(np.eye(filt.shape[-1])[i], input_columns, mode)
        total += np.kron(column_pattern, block)
    return total


def construct_conv2d_matrix(
    filt, input_rows: int, input_columns: int, *, mode: str = "valid", device: DeviceArg = None
) -> torch.Tensor:
    """Dense 2d convolution matrix on column-major flattened images:
    ``scipy.signal.convolve2d`` plus a reshape."""
    return _tensor(_conv2d_matrix_np(_host(filt), input_rows, input_columns, mode), device, filt)


def _strided_conv2d_matrix_np(
    filt: np.ndarray, input_rows: int, input_columns: int, stride: int, mode: str
) -> np.ndarray:
    dense = _conv2d_matrix_np(filt, input_rows, input_columns, mode)
    if mode == "full":
        out_rows = input_rows + filt.shape[0] - 1
        out_cols = input_columns + filt.shape[1] - 1
    elif mode in ("same", "sameshift"):
        out_rows, out_cols = input_rows, input_columns
    else:
        out_rows = input_rows - filt.shape[0] + 1
        out_cols = input_columns - filt.shape[1] + 1
    offset = 1 if mode == "sameshift" else 0
    grid = np.arange(out_rows * out_cols).reshape(out_cols, out_rows)
    keep = grid[offset::stride, offset::stride].reshape(-1)
    return dense[np.sort(keep)]


def construct_strided_conv2d_matrix(
    filt,
    input_rows: int,
    input_columns: int,
    stride: int = 2,
    *,
    mode: str = "valid",
    device: DeviceArg = None,
) -> torch.Tensor:
    """Dense strided 2d convolution matrix (column-major vec)."""
    return _tensor(
        _strided_conv2d_matrix_np(_host(filt), input_rows, input_columns, stride, mode), device, filt
    )


def sparse_kron(a, b) -> torch.Tensor:
    """Kronecker product (dense here; the name is kept for compatibility)."""
    if not isinstance(a, torch.Tensor):
        a = _tensor(np.asarray(a), None, b)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b), device=a.device)
    return torch.kron(a, b.to(a.dtype))


def cat_sparse_identity_matrix(matrix, new_length: int) -> torch.Tensor:
    """Extend a square operator with an identity pass-through block.

    Raises:
        ValueError: if ``matrix`` is not a square 2d matrix or if
            ``new_length`` is smaller than its number of rows.
    """
    host = _host(matrix)
    if host.ndim != 2:
        raise ValueError("Only 2d matrices are supported.")
    if host.shape[0] != host.shape[1]:
        raise ValueError("Matrices must be square. Odd inputs can cause non-square matrices.")
    if new_length < host.shape[0]:
        raise ValueError("Cannot add negatively many rows.")
    out = np.eye(new_length, dtype=host.dtype)
    out[: host.shape[0], : host.shape[1]] = host
    return _tensor(out, None, matrix)


def batch_mm(matrix, batched: torch.Tensor) -> torch.Tensor:
    """``matrix @ batched`` broadcast over the leading batch axis, at the
    matrix transforms' precision (:func:`~ptwt_tpu_torch.ops.get_precision`)."""
    if not isinstance(matrix, torch.Tensor):
        matrix = torch.as_tensor(np.asarray(matrix))
    return axis_matmul(batched, matrix.to(device=batched.device, dtype=batched.dtype), -2)
