"""The control: the plain reference put in the program's place, one
precision below the configuration's.

The configurations state float32, and the port computes in float32 with
TF32 off.  The nearest precision below is TF32: each operand of each
filter product rounded to 10 mantissa bits (round to nearest, ties to
even), the products and sums in float32, as a convolution with TF32
allowed computes them.  Gradients flowing back to an operand are rounded
the same way, so the backward products are TF32 products too.
"""

from __future__ import annotations

import torch

from . import dwt


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits."""
    if t.dtype != torch.float32:
        raise TypeError("TF32 rounding takes float32")
    bits = t.contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return tf32_round(t)

    @staticmethod
    def backward(ctx, grad):
        return tf32_round(grad)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """:func:`tf32_round`, differentiable (its gradient rounded too)."""
    return _TF32.apply(t)


class Control:
    """The reference transform in TF32, with the program's interface
    (:class:`portbench.program.Program`)."""

    def __init__(self, config: dict, device) -> None:
        self.mode, self.level, self.ndim = config["mode"], config["level"], len(config["shape"])
        self.bank = dwt.bank(config["wavelet"], torch.float32, device)

    def _filters(self, wavelet):
        return self.bank if isinstance(wavelet, str) else tuple(wavelet)

    def analysis(self, x: torch.Tensor, wavelet):
        return dwt.wavedec(x, self._filters(wavelet), self.mode, self.level, self.ndim, cast=tf32)

    def synthesis(self, coeffs, wavelet) -> torch.Tensor:
        return dwt.waverec(coeffs, self._filters(wavelet), self.ndim, cast=tf32)

    def learnable_bank(self, filters):
        from .bank_losses import Bank

        return Bank(filters)
