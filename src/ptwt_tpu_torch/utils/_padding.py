"""Signal-extension (padding) library.

Counterpart of :mod:`ptwt_tpu.utils._padding`.  ``jnp.pad`` follows numpy
semantics (``reflect``, ``symmetric`` and ``wrap`` accept pads longer than
the axis); ``torch.nn.functional.pad`` has no ``symmetric`` mode and its
``reflect`` needs pad < length.  So every mode except ``zero`` is built as
one index gather over the pywt source-index map (:func:`source_index`),
which also covers pads longer than the signal.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import BoundaryMode

#: pywt boundary mode -> numpy pad mode name.  Note the naming clash: pywt
#: "constant" means edge replication while pywt "zero" means zero padding.
_MODE_TO_NUMPY = {
    "constant": "edge",
    "zero": "constant",
    "reflect": "reflect",
    "periodic": "wrap",
    "symmetric": "symmetric",
}


def translate_mode(mode: Optional[BoundaryMode]) -> str:
    """Translate a pywt boundary mode into the numpy pad mode name."""
    if mode is None:
        return _MODE_TO_NUMPY["reflect"]
    try:
        return _MODE_TO_NUMPY[mode]
    except KeyError:
        raise ValueError(f"Padding mode not supported: {mode}") from None


def get_pad(data_len: int, filt_len: int) -> tuple[int, int]:
    """pywt-compatible pad sizes for one axis.

    ``total_pad = 2*filt_len - 3`` makes the strided conv output length equal
    pywt's ``floor((data_len + filt_len - 1)/2)``; one extra right pad keeps
    odd lengths even.
    """
    padr = (2 * filt_len - 3) // 2
    padl = (2 * filt_len - 3) // 2
    padr += data_len % 2
    return padl, padr


def source_index(p: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Map (possibly out-of-range) extended positions to source indices.

    Implements the pywt boundary extensions as index maps; returns -1 where
    a position contributes nothing (``zero`` mode).  Positions are relative
    to the unpadded signal (may be negative or >= n).
    """
    if mode == "zero":
        return np.where((p >= 0) & (p < n), p, -1)
    if mode == "periodic":
        return np.mod(p, n)
    if mode == "constant":
        return np.clip(p, 0, n - 1)
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(p)
        period = 2 * n - 2
        q = np.mod(p, period)
        return np.where(q < n, q, period - q)
    if mode == "symmetric":
        period = 2 * n
        q = np.mod(p, period)
        return np.where(q < n, q, period - 1 - q)
    if mode == "periodization":
        # replicate-pad odd lengths to even, then wrap
        n_eff = n + (n % 2)
        q = np.mod(p, n_eff)
        return np.minimum(q, n - 1)
    raise ValueError(f"Padding mode not supported: {mode}")


def _pad_axis(
    data: torch.Tensor, axis: int, padl: int, padr: int, mode: str
) -> torch.Tensor:
    n = data.shape[axis]
    if mode == "zero":
        moved = data.movedim(axis, -1)
        return torch.nn.functional.pad(moved, (padl, padr)).movedim(-1, axis)
    src = source_index(np.arange(-padl, n + padr), n, mode)
    index = torch.as_tensor(src, dtype=torch.long, device=data.device)
    return torch.index_select(data, axis, index)


def fwt_pad(
    data: torch.Tensor,
    filt_len: int,
    *,
    mode: Optional[BoundaryMode] = None,
    axes: Optional[Sequence[int]] = None,
    padding: Optional[Sequence[tuple[int, int]]] = None,
) -> torch.Tensor:
    """Pad the ``axes`` of ``data`` for one FWT level.

    Args:
        data: Input tensor.
        filt_len: Wavelet filter length.
        mode: pywt boundary mode (defaults to ``reflect``).
        axes: Axes to pad (defaults to the last axis).
        padding: Optional explicit per-axis ``(padl, padr)`` overriding the
            pywt rule.

    Returns:
        The padded tensor.
    """
    if axes is None:
        axes = (-1,)
    if mode is None:
        mode = "reflect"
    if mode == "periodization":
        # exact-N/2 circular DWT: replicate-pad odd axes to even (pywt
        # convention), then wrap-pad filt_len//2 - 1 per side; both are
        # folded into the one source-index map
        pad = filt_len // 2 - 1
        for axis in axes:
            n = data.shape[axis]
            data = _pad_axis(data, axis, pad, pad + n % 2, mode)
        return data
    for i, axis in enumerate(axes):
        if padding is None:
            padl, padr = get_pad(data.shape[axis], filt_len)
        else:
            padl, padr = padding[i]
        data = _pad_axis(data, axis, padl, padr, mode)
    return data
