"""Periodization wrap, and the precision of the port's matrix products.

Counterpart of :mod:`ptwt_tpu.ops._conv`.  The hand-written kernels and
their plain versions compute in the input's dtype throughout.  The
boundary-wavelet matrix transforms multiply by dense operators, and those
products follow :func:`set_precision`/:func:`get_precision`, the
counterpart of the JAX module's knob (whose default is
``Precision.HIGHEST``): the default ``"highest"`` computes every float32
product in full float32 on the card, whatever the caller has set with
``torch.set_float32_matmul_precision`` or
``torch.backends.cuda.matmul.allow_tf32``.  :func:`axis_matmul` sets the
precision around each product, forward and backward, and restores the
caller's setting afterwards.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["axis_matmul", "get_precision", "periodization_wrap", "set_precision"]

#: Float32 matmul precision of the matrix transforms, in the names of
#: ``torch.set_float32_matmul_precision``: ``"highest"`` (full float32,
#: the default), ``"high"`` or ``"medium"`` (TF32 on the card).
_PRECISION = "highest"
_PRECISIONS = ("highest", "high", "medium")


def set_precision(precision: str) -> None:
    """Set the matrix transforms' float32 matmul precision globally."""
    global _PRECISION
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    _PRECISION = precision


def get_precision() -> str:
    """The matrix transforms' float32 matmul precision."""
    return _PRECISION


@contextlib.contextmanager
def _matmul_precision():
    """Run the products inside at :data:`_PRECISION`; restore the caller's
    setting, through the API the caller used, afterwards."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:
        # the caller set the newer per-backend flag: read and restore it
        matmul = torch.backends.cuda.matmul
        prev = matmul.fp32_precision
        matmul.fp32_precision = "ieee" if _PRECISION == "highest" else "tf32"
        try:
            yield
        finally:
            matmul.fp32_precision = prev
        return
    if prev == _PRECISION:
        yield
        return
    torch.set_float32_matmul_precision(_PRECISION)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _product(x: torch.Tensor, matrix: torch.Tensor, axis: int) -> torch.Tensor:
    with _matmul_precision():
        if axis == -1:
            return x @ matrix.mT
        if axis == -2:
            return matrix @ x
        return (x.movedim(axis, -1) @ matrix.mT).movedim(-1, axis)


class _AxisMatmul(torch.autograd.Function):
    """``matrix`` applied along ``axis``; the backward applies its
    transpose at the same precision."""

    @staticmethod
    def forward(ctx, x, matrix, axis):
        ctx.save_for_backward(matrix)
        ctx.axis = axis
        return _product(x, matrix, axis)

    @staticmethod
    def backward(ctx, ct):
        (matrix,) = ctx.saved_tensors
        return _AxisMatmul.apply(ct, matrix.mT, ctx.axis), None, None


def axis_matmul(x: torch.Tensor, matrix: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``out[..., k, ...] = sum_j matrix[k, j] x[..., j, ...]`` along
    ``axis`` (negative), at :func:`get_precision`.  ``matrix`` is a
    constant operator: no gradient reaches it."""
    return _AxisMatmul.apply(x, matrix.detach(), axis)


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
