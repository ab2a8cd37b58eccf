"""Filter-bank convolutions, the periodization wrap, and the precision of
the port's dense products.

Counterpart of :mod:`ptwt_tpu.ops._conv`.  The hand-written kernels and
their plain versions compute in the input's dtype throughout.  The dense
products (the boundary-wavelet matrix transforms, and under a reduced
precision the dense-operator route of :mod:`._dispatch`) and the
convolutions here follow :func:`set_precision`/:func:`get_precision`, the
counterpart of the JAX module's knob, whose levels it takes by name:

* ``"highest"`` (the default, JAX's ``Precision.HIGHEST``): full float32,
  whatever the caller has set with ``torch.set_float32_matmul_precision``,
  ``torch.backends.cuda.matmul.allow_tf32`` or
  ``torch.backends.cudnn.allow_tf32``;
* ``"high"`` (JAX's ``Precision.HIGH``) and ``"medium"``: TF32 products
  and convolutions on the card;
* ``"default"`` (JAX's ``Precision.DEFAULT``): products with bfloat16
  operands, float32 accumulation and a float32 result
  (``torch.mm``/``torch.bmm`` with ``out_dtype=torch.float32``); TF32
  convolutions.

Only float32 tensors on the card compute at a reduced precision: on the
CPU, and in float64 everywhere, every level computes exactly, as JAX on
the CPU does.  :func:`axis_matmul` and the convolutions set the
precision around each call, forward and backward, and restore the
caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ._library import NAMESPACE, autograd, batch_first, call, no_batched

__all__ = [
    "analysis_conv",
    "aligned_operator",
    "axis_matmul",
    "get_precision",
    "operand_dtype",
    "periodization_wrap",
    "set_precision",
    "synthesis_conv",
]

#: Float32 precision of the dense products and convolutions: ``"highest"``
#: (full float32, the default), ``"high"`` or ``"medium"`` (TF32 on the
#: card), ``"default"`` (bfloat16 operands, float32 accumulation).
_PRECISION = "highest"
_PRECISIONS = ("highest", "high", "medium", "default")

#: Below ``"highest"`` the operands are padded to this many elements along
#: their contracted and stored axes: cuBLAS takes its fast kernels only for
#: 16-byte-aligned rows.
_ALIGN = 8


def set_precision(precision: str) -> None:
    """Set the float32 precision of the dense products and convolutions."""
    global _PRECISION
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    _PRECISION = precision


def get_precision() -> str:
    """The float32 precision of the dense products and convolutions."""
    return _PRECISION


def _level(x: torch.Tensor) -> str:
    """The precision a product or convolution of ``x`` runs at: the set
    one for float32 on the card, ``"highest"`` everywhere else."""
    if x.dtype == torch.float32 and x.device.type == "cuda":
        return _PRECISION
    return "highest"


@contextlib.contextmanager
def _matmul_precision(level: str):
    """Run the products inside at ``level`` (``"highest"``, ``"high"`` or
    ``"medium"``); restore the caller's setting, through the API the
    caller used, afterwards."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:
        # the caller set the newer per-backend flag: read and restore it
        matmul = torch.backends.cuda.matmul
        prev = matmul.fp32_precision
        matmul.fp32_precision = "ieee" if level == "highest" else "tf32"
        try:
            yield
        finally:
            matmul.fp32_precision = prev
        return
    if prev == level:
        yield
        return
    torch.set_float32_matmul_precision(level)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def _conv_precision(level: str):
    """Run cuDNN's float32 convolutions inside with TF32 allowed below
    ``"highest"`` only; restore the caller's setting afterwards."""
    allow = level != "highest"
    cudnn = torch.backends.cudnn
    try:
        prev = cudnn.allow_tf32
    except RuntimeError:
        # the caller set the newer per-operator flags: read and restore it
        prev = cudnn.conv.fp32_precision
        cudnn.conv.fp32_precision = "tf32" if allow else "ieee"
        try:
            yield
        finally:
            cudnn.conv.fp32_precision = prev
        return
    if prev == allow:
        yield
        return
    cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def operand_dtype(x: torch.Tensor) -> torch.dtype | None:
    """The dtype of the operator in a product of ``x`` below ``"highest"``
    (bfloat16 under ``"default"``, float32 under ``"high"``/``"medium"``);
    None where the product of ``x`` runs at ``"highest"``."""
    level = _level(x)
    if level == "highest":
        return None
    return torch.bfloat16 if level == "default" else torch.float32


def aligned_operator(matrix: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``matrix`` as ``dtype``, zero-padded to ``_ALIGN`` rows and columns:
    the operator operand of a product below ``"highest"``."""
    rows, cols = matrix.shape
    return F.pad(matrix.to(dtype), (0, -cols % _ALIGN, 0, -rows % _ALIGN))


def _padded_product(
    x: torch.Tensor, op: torch.Tensor, shape: tuple[int, int], axis: int, transposed: bool
) -> torch.Tensor:
    """The ``shape`` operator (or its transpose) along ``axis`` of the
    float32 ``x``, from its aligned copy ``op``: bfloat16 operands with
    float32 accumulation and a float32 result (a bfloat16 ``op``), or TF32
    products (a float32 ``op``).

    ``x`` is copied (and cast) into a buffer whose contracted axis is
    padded with zeros to ``op``'s, so that cuBLAS takes its aligned
    kernels, and the result is a view of the padded float32 product.
    """
    dtype = op.dtype
    rows, n = shape[::-1] if transposed else shape
    if transposed:
        op = op.mT
    ax = axis % x.ndim
    lead, tail = x.shape[:ax], x.shape[ax + 1 :]
    p, q = math.prod(lead), math.prod(tail)
    width = op.shape[1]
    kwargs = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}
    precision = contextlib.nullcontext() if kwargs else _matmul_precision(_level(x))
    if not tail:
        xb = x.new_empty((p, width), dtype=dtype)
        xb[:, n:].zero_()
        xb[:, :n].view(*lead, n).copy_(x)
        with precision:
            out = torch.mm(xb, op.mT, **kwargs)
        return out[:, :rows].view(*lead, rows)
    # the stored axis is padded too (its pad columns of the product are
    # dropped, so they need no zeros)
    xb = x.new_empty((p, width, -(-q // _ALIGN) * _ALIGN), dtype=dtype)
    xb[:, n:].zero_()
    xb[:, :n, :q].view(*lead, n, *tail).copy_(x)
    with precision:
        out = torch.bmm(op.expand(p, *op.shape), xb, **kwargs)
    return out[:, :rows, :q].view(*lead, rows, *tail)


def _product(x, matrix, aligned, axis: int, transposed: bool) -> torch.Tensor:
    if aligned is not None:
        return _padded_product(x, aligned, tuple(matrix.shape), axis, transposed)
    op = matrix.mT if transposed else matrix
    with _matmul_precision("highest"):
        if axis == -1:
            return x @ op.mT
        if axis == -2:
            return op @ x
        return (x.movedim(axis, -1) @ op.mT).movedim(-1, axis)


@torch.library.custom_op(f"{NAMESPACE}::axis_matmul", mutates_args=())
def _axis_matmul(
    x: torch.Tensor, matrix: torch.Tensor, aligned: Optional[torch.Tensor], axis: int, transposed: bool
) -> torch.Tensor:
    """``matrix`` (its transpose) applied along the negative ``axis`` of
    ``x``, from ``aligned`` where given (:func:`_product`)."""
    return _product(x, matrix, aligned, axis, transposed)


# the same torch ops on fake tensors give the product's shape and strides
_axis_matmul.register_fake(_product)


def _axis_matmul_setup(ctx, inputs, output):
    x, matrix, aligned, axis, transposed = inputs
    ctx.save_for_backward(matrix, aligned)
    ctx.axis, ctx.transposed = axis, transposed


def _axis_matmul_backward(ctx, ct):
    """The transpose, from the forward's operands."""
    matrix, aligned = ctx.saved_tensors
    return call(_axis_matmul, ct, matrix, aligned, ctx.axis, not ctx.transposed), None, None, None, None


@_axis_matmul.register_vmap
def _(info, in_dims, x, matrix, aligned, axis, transposed):
    no_batched("axis_matmul", in_dims, 1, 2)
    x = batch_first(x, in_dims[0], info.batch_size)
    return _axis_matmul(x, matrix, aligned, axis, transposed), 0


autograd(_axis_matmul, _axis_matmul_setup, _axis_matmul_backward)


def axis_matmul(
    x: torch.Tensor, matrix: torch.Tensor, axis: int = -1, aligned: torch.Tensor | None = None
) -> torch.Tensor:
    """``out[..., k, ...] = sum_j matrix[k, j] x[..., j, ...]`` along
    ``axis`` (negative), at :func:`get_precision`; the backward takes the
    forward's operands.  ``matrix`` is a constant operator: no gradient
    reaches it.  ``aligned`` is its :func:`aligned_operator` copy at
    :func:`operand_dtype` of ``x``, where the caller keeps one
    (:mod:`._matmul` caches them); below ``"highest"`` one is built for
    the call otherwise."""
    dtype = operand_dtype(x)
    if dtype is None:
        aligned = None
    elif aligned is None or aligned.dtype != dtype:
        aligned = aligned_operator(matrix, dtype)
    return call(_axis_matmul, x, matrix, aligned, axis % x.ndim - x.ndim, False)


_CONVS = {1: (F.conv1d, F.conv_transpose1d), 2: (F.conv2d, F.conv_transpose2d),
                3: (F.conv3d, F.conv_transpose3d)}


def analysis_conv(data: torch.Tensor, filt) -> torch.Tensor:
    """One FWT analysis level: valid convolution with stride 2 on every
    spatial axis (cuDNN on the card, at :func:`get_precision`).

    Args:
        data: ``[batch, *spatial]`` (already padded), ``ndim`` spatial axes.
        filt: ``[2**ndim, 1, *kernel]`` subband filter stack, **already
            flipped** so that the underlying correlation computes a true
            convolution (as ``construct_nd_filter`` builds it from
            ``get_filter_arrays(..., flip=True)``).

    Returns:
        ``[batch, 2**ndim, *spatial_out]`` with ``spatial_out = (s - k)//2 + 1``.
    """
    filt = torch.as_tensor(filt, dtype=data.dtype, device=data.device)
    ndim = filt.ndim - 2
    with _conv_precision(_level(data)):
        return _CONVS[ndim][0](data.unsqueeze(1), filt, stride=2)


def synthesis_conv(coeffs: torch.Tensor, filt) -> torch.Tensor:
    """One FWT synthesis level: stride-2 transposed convolution summing the
    subbands (cuDNN on the card, at :func:`get_precision`).

    Args:
        coeffs: ``[batch, 2**ndim, *spatial]`` subband stack.
        filt: ``[2**ndim, 1, *kernel]`` reconstruction filter stack
            (**unflipped**, as stored in the wavelet object).

    Returns:
        ``[batch, *spatial_out]`` with ``spatial_out = (s-1)*2 + k``.
    """
    filt = torch.as_tensor(filt, dtype=coeffs.dtype, device=coeffs.device)
    ndim = filt.ndim - 2
    with _conv_precision(_level(coeffs)):
        return _CONVS[ndim][1](coeffs, filt, stride=2)[:, 0]


def periodization_wrap(data: torch.Tensor, axis: int, filt_len: int) -> torch.Tensor:
    """Fold the overhanging ends of a synthesis output back circularly.

    In ``periodization`` mode the analysis circularly pads each axis by
    ``filt_len//2 - 1`` per side; the inverse therefore adds synthesis
    sample ``p`` onto output ``(p - filt_len//2 + 1) mod 2n``, yielding
    exactly twice the coefficient length.  The fold is taken modulo the
    output length, so it stays exact when the overhang is longer than the
    output (long filters on short axes), where wrapping each end once
    would not be.
    """
    pad = filt_len // 2 - 1
    moved = data.movedim(axis, -1)
    size = moved.shape[-1]
    target = size - (filt_len - 2)  # (n-1)*2 + L  ->  2n
    if target <= 0:  # no band samples (n = 0): nothing to fold onto
        return moved[..., :0].movedim(-1, axis)
    # place sample p at (p - pad) + k*target for some k >= 0, then sum the
    # target-long chunks
    start = (-pad) % target
    total = -(-(start + size) // target) * target
    padded = F.pad(moved, (start, total - start - size))
    folded = padded.reshape(*moved.shape[:-1], total // target, target).sum(-2)
    return folded.movedim(-1, axis)
