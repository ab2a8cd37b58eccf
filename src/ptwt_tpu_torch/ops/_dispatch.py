"""Routing of one 2d FWT level (analysis + synthesis) to the kernels.

Counterpart of :mod:`ptwt_tpu.ops._dispatch` for ``ndim=2``.  The JAX
package picks among XLA and Pallas routes by TPU measurements and Mosaic
limits; the port keeps only the routing contract of the two Pallas kernel
pairs, with no TPU size gates:

* analysis: ``periodization``, or ``periodic`` on an even shape, whose
  half-size axes cover the tap reach, runs K1 once; every other level runs
  K3 along axis -2, then K3 along axis -1 on the packed (lo, hi) pair.
* synthesis: one subband shape and the standard crop runs K2 once; every
  other level runs K4 along axis -1 on both (lo, hi) pairs in one launch,
  then along axis -2.

On a CPU tensor the same decisions call the kernels' plain versions.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ._pallas2 import pallas_dwt_axis, pallas_idwt_axis
from ._pallas2d import (
    fused2_analysis_applicable,
    fused2_dwt_level,
    fused2_idwt_level,
    fused2_synthesis_applicable,
)

__all__ = ["analysis_nd", "synthesis_nd", "dwt_axis", "idwt_axis"]


#: One analysis level along an axis, packed ``[2, ...]`` as (lo, hi); the
#: port has one per-axis route, the K3 wrapper.
dwt_axis = pallas_dwt_axis

#: One synthesis level along an axis for each (lo, hi) pair, stacked
#: ``[G, ...]``; the port has one per-axis route, the K4 wrapper.
idwt_axis = pallas_idwt_axis


def _check_ndim(ndim: int) -> None:
    if ndim != 2:
        raise NotImplementedError(
            f"{ndim}d levels are not ported yet; ptwt_tpu_torch runs 2d transforms"
        )


def analysis_nd(
    data: torch.Tensor, dec_lo, dec_hi, *, mode: str, ndim: int
) -> tuple[torch.Tensor, ...]:
    """One analysis level over the trailing ``ndim`` axes of ``[B, *sp]``.

    Returns the subbands in ``SUBBAND_ORDERS`` order ``(ll, lh, hl, hh)``.
    """
    _check_ndim(ndim)
    h, w = data.shape[-2:]
    if fused2_analysis_applicable(h, w, len(dec_lo), mode):
        return fused2_dwt_level(data, dec_lo, dec_hi, mode)
    rows = dwt_axis(data, -2, dec_lo, dec_hi, mode)  # [2 (H bit), B, m_h, w]
    both = dwt_axis(rows, -1, dec_lo, dec_hi, mode)  # [2 (W bit), 2, B, m_h, m_w]
    return both[0, 0], both[0, 1], both[1, 0], both[1, 1]


def synthesis_nd(
    subbands: Sequence[torch.Tensor],
    rec_lo,
    rec_hi,
    *,
    pads: Sequence[tuple[int, int]],
    mode: str,
    ndim: int,
) -> torch.Tensor:
    """One synthesis level: ``(ll, lh, hl, hh)`` -> ``[B, *spatial_out]``.

    ``pads`` are the per-axis ``(padl, padr)`` crops for axes ``(-2, -1)``;
    the caller resolves the odd-length crop ambiguity.  Unflipped
    reconstruction filters; ``periodization`` folds circularly.
    """
    _check_ndim(ndim)
    ll, lh, hl, hh = subbands
    if len({b.shape for b in subbands}) == 1 and fused2_synthesis_applicable(
        ll.shape[-2], ll.shape[-1], len(rec_lo), mode, pads
    ):
        return fused2_idwt_level(subbands, rec_lo, rec_hi, mode)
    cols = idwt_axis((ll, lh), (hl, hh), -1, rec_lo, rec_hi, *pads[1], mode)
    return idwt_axis((cols[0],), (cols[1],), -2, rec_lo, rec_hi, *pads[0], mode)[0]
