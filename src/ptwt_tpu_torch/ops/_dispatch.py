"""Routing of one 1d, 2d or 3d FWT level (analysis + synthesis) to the kernels.

Counterpart of :mod:`ptwt_tpu.ops._dispatch` for ``ndim`` 1 to 3.  The
JAX package picks among XLA and Pallas routes by TPU measurements and
Mosaic limits; the port keeps only the routing contract of the Pallas
kernel pairs, with no TPU size gates beyond the long-axis floor of K7:

* per axis: a last axis longer than ``2**16`` samples in a padded mode
  (or ``valid``) runs K7 (:mod:`._pallas1d`), as the JAX package's
  ``dwt_axis``/``idwt_axis`` route it; every other axis runs K3/K4.
* 1d: one level is one per-axis call on the last axis.
* 2d analysis: ``periodization``, or ``periodic`` on an even shape, whose
  half-size axes cover the tap reach, runs K1 once; every other level runs
  K3 along axis -2, then the per-axis route along axis -1 on the packed
  (lo, hi) pair.
* 2d synthesis: one subband shape and the standard crop runs K2 once;
  every other level runs the per-axis route along axis -1 on both (lo, hi)
  pairs (K4: one launch), then along axis -2.
* 3d analysis: the per-axis route along axes -3, -2 and -1 in turn, each
  pass on the packed output of the last, so the sibling blocks ride in
  the kernel's ``outer`` (K3: three launches, no stack).
* 3d synthesis: the per-axis route along axis -1 on the four (lo, hi)
  pairs in two two-pair launches, whose outputs are the lo and hi stacks
  of the axis -2 pass (one two-pair launch), then axis -3 (one launch):
  four K4 launches and no stacking copy.
* with the opt-in ``PTWT_TPU_MXU2D=1``, a float32 K1/K2 level whose
  full-resolution image has ``h % 128 == 0`` and ``w % 256 == 0`` (at most
  64 taps) runs the tensor-core K9a/K9b instead, forward and VJP
  (:mod:`._mxu2d`); the choice is made inside :mod:`._pallas2d`.

A ``periodization`` level reaches this module only where the whole
pyramid does not run fused: ``wavedec``/``waverec`` send an exactly
halving 1d chain to K6 and ``wavedec2``/``waverec2`` a 2d chain that the
K5 plan holds to K5 (:mod:`._pallas`), before any level is routed here.
Here a 2d periodization level runs K1/K2, a 1d one K3/K4.

A filter bank that requires grad (:func:`~._kernels.filters_need_grad`,
the counterpart of the JAX package's ``_is_concrete``) declines K7 and
K1/K2 (so K9) here, as the entry points decline K5, K6 and K8 for it:
every axis of every level runs K3/K4, whose backward gives the filters'
gradient (KT).  Under ``torch.no_grad()`` the routes are the ones above.

On a CPU tensor the same decisions call the kernels' plain versions.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils._preprocess import SUBBAND_ORDERS
from ._kernels import filters_need_grad
from ._pallas1d import dwt_lane_packed, flat_idwt_lane, flat_lane_applicable
from ._pallas2 import pallas_dwt_axis, pallas_idwt_axis
from ._pallas2d import (
    fused2_analysis_applicable,
    fused2_dwt_level,
    fused2_idwt_level,
    fused2_synthesis_applicable,
)

__all__ = ["analysis_nd", "synthesis_nd", "dwt_axis", "idwt_axis"]


def dwt_axis(x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str) -> torch.Tensor:
    """One analysis level along ``axis``, packed ``[2, ...]`` as (lo, hi):
    K7 on a long last axis in a padded mode, K3 otherwise.

    Raises:
        ValueError: For an odd-length bank in ``periodization`` on an empty
            axis, whose level would have -1 bands (``ptwt_tpu`` raises
            there too).
    """
    if mode == "periodization" and len(dec_lo) % 2 and not x.shape[axis]:
        raise ValueError(
            "negative dimensions are not allowed: an odd-length filter bank's "
            "periodization level on an empty axis has -1 coefficients"
        )
    if (
        axis % x.ndim == x.ndim - 1
        and not filters_need_grad(dec_lo, dec_hi)
        and flat_lane_applicable(x.shape[-1], len(dec_lo), mode)
    ):
        return dwt_lane_packed(x, dec_lo, dec_hi, mode)
    return pallas_dwt_axis(x, axis, dec_lo, dec_hi, mode)


def idwt_axis(
    los: Sequence[torch.Tensor],
    his: Sequence[torch.Tensor],
    axis: int,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
    mode: str,
) -> torch.Tensor:
    """One synthesis level along ``axis`` for each (lo, hi) pair, stacked
    ``[G, ...]``: K7 per pair on a long last axis (gated on the output
    length, any mode but periodization), K4 for all pairs otherwise."""
    ndim = los[0].ndim
    if axis % ndim == ndim - 1 and mode != "periodization" and not filters_need_grad(rec_lo, rec_hi):
        out_len = 2 * (los[0].shape[-1] - 1) + len(rec_lo) - padl - padr
        if flat_lane_applicable(out_len, len(rec_lo), mode):
            outs = [flat_idwt_lane(a, b, rec_lo, rec_hi, padl, padr) for a, b in zip(los, his)]
            return outs[0].unsqueeze(0) if len(outs) == 1 else torch.stack(outs)
    return pallas_idwt_axis(los, his, axis, rec_lo, rec_hi, padl, padr, mode)


def _check_ndim(ndim: int) -> None:
    if ndim not in (1, 2, 3):
        raise NotImplementedError(
            f"{ndim}d levels are not ported; ptwt_tpu_torch runs 1d, 2d and 3d transforms"
        )


def analysis_nd(
    data: torch.Tensor, dec_lo, dec_hi, *, mode: str, ndim: int
) -> tuple[torch.Tensor, ...]:
    """One analysis level over the trailing ``ndim`` axes of ``[B, *sp]``.

    Returns the subbands in ``SUBBAND_ORDERS`` order: ``(lo, hi)`` in 1d,
    ``(ll, lh, hl, hh)`` in 2d, the eight ``(d, h, w)`` selections in 3d.
    """
    _check_ndim(ndim)
    if ndim == 1:
        lo, hi = dwt_axis(data, -1, dec_lo, dec_hi, mode).unbind(0)
        return lo, hi
    if ndim == 3:
        packed = data
        for axis in (-3, -2, -1):
            packed = dwt_axis(packed, axis, dec_lo, dec_hi, mode)
        # [2 (w bit), 2 (h bit), 2 (d bit), B, d, h, w]: flat index 4w + 2h
        # + d; one unbind, whose backward stacks the eight cotangents once
        bands = packed.flatten(0, 2).unbind(0)
        return tuple(bands[4 * w + 2 * h + d] for d, h, w in SUBBAND_ORDERS[3])
    h, w = data.shape[-2:]
    if not filters_need_grad(dec_lo, dec_hi) and fused2_analysis_applicable(h, w, len(dec_lo), mode):
        return fused2_dwt_level(data, dec_lo, dec_hi, mode)
    rows = dwt_axis(data, -2, dec_lo, dec_hi, mode)  # [2 (H bit), B, m_h, w]
    both = dwt_axis(rows, -1, dec_lo, dec_hi, mode)  # [2 (W bit), 2, B, m_h, m_w]
    # unbind, not indexing: its backward stacks the four cotangents once
    (ll, lh), (hl, hh) = (half.unbind(0) for half in both.unbind(0))
    return ll, lh, hl, hh


def synthesis_nd(
    subbands: Sequence[torch.Tensor],
    rec_lo,
    rec_hi,
    *,
    pads: Sequence[tuple[int, int]],
    mode: str,
    ndim: int,
) -> torch.Tensor:
    """One synthesis level: ``(lo, hi)``, ``(ll, lh, hl, hh)`` or the eight
    3d subbands (``SUBBAND_ORDERS`` order) -> ``[B, *spatial_out]``.

    ``pads`` are the per-axis ``(padl, padr)`` crops for the trailing
    ``ndim`` axes; the caller resolves the odd-length crop ambiguity.
    Unflipped reconstruction filters; ``periodization`` folds circularly.
    """
    _check_ndim(ndim)
    if ndim == 1:
        lo, hi = subbands
        return idwt_axis((lo,), (hi,), -1, rec_lo, rec_hi, *pads[0], mode).squeeze(0)
    if ndim == 3:
        # index (d, h, w) -> 4d + 2h + w; pass -1 pairs w = 0 with w = 1
        band = list(subbands)
        lo_h = idwt_axis(band[0::4], band[1::4], -1, rec_lo, rec_hi, *pads[2], mode)  # (d, h=0)
        hi_h = idwt_axis(band[2::4], band[3::4], -1, rec_lo, rec_hi, *pads[2], mode)  # (d, h=1)
        d_pair = idwt_axis(lo_h.unbind(0), hi_h.unbind(0), -2, rec_lo, rec_hi, *pads[1], mode)
        lo, hi = d_pair.unbind(0)
        return idwt_axis((lo,), (hi,), -3, rec_lo, rec_hi, *pads[0], mode).squeeze(0)
    ll, lh, hl, hh = subbands
    if (
        len({b.shape for b in subbands}) == 1
        and not filters_need_grad(rec_lo, rec_hi)
        and fused2_synthesis_applicable(ll.shape[-2], ll.shape[-1], len(rec_lo), mode, pads)
    ):
        return fused2_idwt_level(subbands, rec_lo, rec_hi, mode)
    lo, hi = idwt_axis((ll, lh), (hl, hh), -1, rec_lo, rec_hi, *pads[1], mode).unbind(0)
    return idwt_axis((lo,), (hi,), -2, rec_lo, rec_hi, *pads[0], mode).squeeze(0)
