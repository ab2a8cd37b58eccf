"""Periodization wrap of a synthesis output.

Counterpart of :func:`ptwt_tpu.ops._conv.periodization_wrap`.  The port
runs no matmul or convolution of its own, so the JAX module's precision
knob has no counterpart yet: the hand-written kernels and the plain
versions compute in the input's dtype throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
