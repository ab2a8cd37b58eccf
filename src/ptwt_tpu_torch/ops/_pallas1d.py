"""One 1d level along a long last axis: the K7 contract.

Counterpart of :mod:`ptwt_tpu.ops._pallas1d`, whose Pallas kernels K7a
(``_window_kernel``) and K7b (``_syn_window_kernel``) run one analysis or
synthesis level over stacked overlapping windows of the signal.  The
windows are a TPU artifact; the contract is the plain single-level
transform.  Here the K8 kernels of ``csrc/fwt1d.cu`` (see
:mod:`._pallas1d_multi`) carry it at depth 1, and each such launch counts
as K7a or K7b:

* **K7a** -- one analysis level in a padded mode or ``valid``; the edge
  block computes the positions whose taps read the mode extension.
* **K7b** -- one synthesis level with the crop folded into the index
  range, every mode but ``periodization`` (the padded modes' synthesis
  does not depend on the mode).

The gate keeps the JAX package's semantics without its Mosaic limits: a
last axis longer than :data:`~._pallas1d_multi.FLAT_MIN_LANES` (``2**16``,
the TPU's threshold, to be set from the card by the port's bench),
float32 and float64 alike, filters of up to 128 taps.  The plain versions
are one level of :func:`~._pallas2.dwt_axis_plain` /
:func:`~._pallas2.idwt_axis_plain` on the last axis; the wrappers take them
for CPU tensors only.

Gradients: each launch is the depth-1 case of the K8 autograd Functions
of :mod:`._pallas1d_multi`, so K7a's VJP is one launch of the synthesis
pyramid kernel with the transpose of the padding gather folded into its
edge block (counted as K7b), and K7b's one launch of the analysis pyramid
kernel (counted as K7a): the transposed single level of the JAX
package's ``custom_vjp``s.
"""

from __future__ import annotations

import math

import torch

from . import _kernels
from ._pallas1d_multi import PADDED_MODES, _LaneAnalysis, _LaneSynthesis, _long_lane
from ._pallas2 import _on_cpu, dwt_axis_plain, idwt_axis_plain

__all__ = [
    "dwt_lane_packed",
    "flat_dwt_lane",
    "flat_idwt_lane",
    "flat_lane_applicable",
]


def flat_lane_applicable(n: int, filt_len: int, mode: str) -> bool:
    """Static gate: a long last axis in a padded mode or ``valid``.  The
    synthesis level is gated on its output length."""
    return mode in (*PADDED_MODES, "valid") and _long_lane(n, filt_len)


def dwt_lane_packed(x: torch.Tensor, dec_lo, dec_hi, mode: str) -> torch.Tensor:
    """One analysis level along the last axis, packed ``[2, ...]`` as
    (lo, hi) like :func:`~._pallas2.pallas_dwt_axis`.  A CPU tensor runs
    :func:`dwt_axis_plain`; a CUDA tensor runs K7a."""
    if _on_cpu(x):
        return torch.stack(dwt_axis_plain(x, -1, dec_lo, dec_hi, mode))
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), x.shape[-1]).contiguous()
    (packed,) = _LaneAnalysis.apply(x2, "K7a", lo, hi, 1, mode)
    return packed.reshape(2, *lead, packed.shape[-1])


def flat_dwt_lane(
    x: torch.Tensor, dec_lo, dec_hi, mode: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis level along the last axis: ``(lo, hi)``.

    ``dec_lo``/``dec_hi`` are flipped (correlation order); ``valid``
    means the caller padded the signal already.
    """
    lo, hi = dwt_lane_packed(x, dec_lo, dec_hi, mode).unbind(0)
    return lo, hi


def flat_idwt_lane(
    lo_band: torch.Tensor,
    hi_band: torch.Tensor,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
) -> torch.Tensor:
    """One synthesis level along the last axis, cropped by
    ``padl``/``padr`` (unflipped filters; any mode but periodization).  A
    CPU tensor runs :func:`idwt_axis_plain`; a CUDA tensor runs K7b."""
    if _on_cpu(lo_band):
        return idwt_axis_plain(lo_band, hi_band, -1, rec_lo, rec_hi, padl, padr, "zero")
    lo = _kernels.static_taps(rec_lo)
    hi = _kernels.static_taps(rec_hi)
    lead = lo_band.shape[:-1]
    m = lo_band.shape[-1]
    out_len = max(2 * (m - 1) + len(lo) - padl - padr, 0)
    bands = [b.reshape(math.prod(lead), m).contiguous() for b in (lo_band, hi_band)]
    out = _LaneSynthesis.apply("K7b", lo, hi, (padl,), out_len, *bands)
    return out.reshape(*lead, out_len)
