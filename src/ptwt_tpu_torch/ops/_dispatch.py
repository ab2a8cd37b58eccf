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

A filter bank that requires grad, or one of tensors while dynamo traces
(:func:`~._kernels.filters_traced`, the counterpart of the JAX package's
``_is_concrete``) declines K7 and K1/K2 (so K9) here, as the entry
points decline K5, K6 and K8 for it: every axis of every level runs
K3/K4, whose backward gives the filters' gradient (KT).  Under
``torch.no_grad()`` an eager run takes the routes above.

Under a reduced precision (:func:`~._conv.set_precision` below
``"highest"``), a float32 level whose bank autograd does not
differentiate runs the dense-operator route, as the JAX package's matmul
route does: every axis of at most :func:`~._matmul.get_matmul_max_length`
samples (the synthesis gated on its output length) is one
:func:`~._conv.axis_matmul` with the mode-folded banded operator of
:mod:`._matmul`, at the set precision; where every axis of a level
qualifies, the level is one product per axis on the packed bands, sliced
into the subbands at the end.  K1/K2 (so the K9 opt-in) decline there, as
the JAX package's K1 gate does; K3/K4 keep the longer axes and K7 the long
last ones.  The pyramids that the entry points route before this module
(K5, K6, K8) stay exact, as the JAX package keeps its K5.

The public :func:`dwt_axis` and :func:`idwt_axis` take and return what
the JAX package's do: ``(lo, hi)`` from one tensor, one tensor from one
``lo`` and one ``hi``.  The port's own modules call the packed forms,
:func:`dwt_axis_packed` (``[2, ...]``) and :func:`idwt_axis_pairs` (any
number of pairs, stacked ``[G, ...]``), which keep K3's packed output and
K4's two pairs a launch.

On a CPU tensor the same decisions call the kernels' plain versions (and
the dense products compute exactly).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils._preprocess import SUBBAND_ORDERS
from ._conv import axis_matmul, get_precision
from ._kernels import filters_traced
from ._matmul import analysis_operator, get_matmul_max_length, synthesis_operator
from ._pallas1d import dwt_lane_packed, flat_idwt_lane, flat_lane_applicable
from ._pallas2 import pallas_dwt_axis, pallas_idwt_axis
from ._pallas2d import (
    fused2_analysis_applicable,
    fused2_dwt_level,
    fused2_idwt_level,
    fused2_synthesis_applicable,
)

__all__ = ["analysis_nd", "synthesis_nd", "dwt_axis", "idwt_axis"]


def _dense(dtype: torch.dtype, *filters) -> bool:
    """Run this level's short axes on the dense-operator route?  Under a
    reduced precision, for float32 and a bank that autograd does not
    differentiate (the JAX package's matmul route takes concrete banks
    only)."""
    return get_precision() != "highest" and dtype == torch.float32 and not filters_traced(*filters)


def _synthesis_out_len(m: int, filt_len: int, padl: int, padr: int, periodization: bool) -> int:
    """Samples one synthesis level gives along an axis of ``m`` bands (the
    operator's rows): the dense route's gate, so that an ``n``-sample round
    trip takes the same route both ways."""
    full = 2 * m if periodization else 2 * (m - 1) + filt_len
    return full - padl - padr


def _neg(axis: int, ndim: int) -> int:
    return axis % ndim - ndim


def _packed(blocks: dict[tuple[int, ...], torch.Tensor], axes: Sequence[int]) -> torch.Tensor:
    """Blocks of one shape, keyed by one (lo, hi) bit per axis of ``axes``,
    laid side by side along those axes (lo first), in one copy."""
    first = next(iter(blocks.values()))
    shape = list(first.shape)
    for axis in axes:
        shape[axis] *= 2
    out = first.new_empty(shape)
    for bits, block in blocks.items():
        index = [slice(None)] * first.ndim
        for axis, bit in zip(axes, bits):
            m = first.shape[axis]
            index[axis] = slice(bit * m, (bit + 1) * m)
        out[tuple(index)] = block
    return out


def dwt_axis_packed(x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str) -> torch.Tensor:
    """One analysis level along ``axis``, packed ``[2, ...]`` as (lo, hi):
    K7 on a long last axis in a padded mode, the dense operator on a short
    axis under a reduced precision, K3 otherwise.

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
        and not filters_traced(dec_lo, dec_hi)
        and flat_lane_applicable(x.shape[-1], len(dec_lo), mode)
    ):
        return dwt_lane_packed(x, dec_lo, dec_hi, mode)
    if _dense(x.dtype, dec_lo, dec_hi) and x.shape[axis] <= get_matmul_max_length():
        axis = _neg(axis, x.ndim)
        op, aligned = analysis_operator(x.shape[axis], dec_lo, dec_hi, mode, x)
        both = axis_matmul(x, op, axis, aligned)
        m = both.shape[axis] // 2
        return torch.stack((both.narrow(axis, 0, m), both.narrow(axis, m, m)))
    return pallas_dwt_axis(x, axis, dec_lo, dec_hi, mode)


def idwt_axis_pairs(
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
    length, any mode but periodization), the dense operator for all pairs
    on a short output under a reduced precision, K4 for all pairs
    otherwise."""
    ndim = los[0].ndim
    periodization = mode == "periodization"
    out_len = _synthesis_out_len(los[0].shape[axis], len(rec_lo), padl, padr, periodization)
    if axis % ndim == ndim - 1 and not periodization and not filters_traced(rec_lo, rec_hi):
        if flat_lane_applicable(out_len, len(rec_lo), mode):
            outs = [flat_idwt_lane(a, b, rec_lo, rec_hi, padl, padr) for a, b in zip(los, his)]
            return outs[0].unsqueeze(0) if len(outs) == 1 else torch.stack(outs)
    if _dense(los[0].dtype, rec_lo, rec_hi) and out_len <= get_matmul_max_length():
        axis = _neg(axis, ndim)
        m = los[0].shape[axis]
        shape = list(los[0].shape)
        shape[axis] = 2 * m
        x = los[0].new_empty((len(los), *shape))  # [G, ..., 2m, ...]: lo first
        for g, (lo, hi) in enumerate(zip(los, his)):
            x[g].narrow(axis, 0, m).copy_(lo)
            x[g].narrow(axis, m, m).copy_(hi)
        op, aligned = synthesis_operator(m, rec_lo, rec_hi, padl, padr, periodization, x)
        return axis_matmul(x, op, axis, aligned)
    return pallas_idwt_axis(los, his, axis, rec_lo, rec_hi, padl, padr, mode)


def dwt_axis(x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis level along ``axis``: ``(lo, hi)``, routed as
    :func:`dwt_axis_packed` routes it.

    ``dec_lo``/``dec_hi`` are flipped (correlation order).  ``mode="valid"``
    means the caller padded the data beforehand; every other mode is
    folded into the level.
    """
    lo, hi = dwt_axis_packed(x, axis, dec_lo, dec_hi, mode).unbind(0)
    return lo, hi


def idwt_axis(
    lo: torch.Tensor,
    hi: torch.Tensor,
    axis: int,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
    mode: str,
) -> torch.Tensor:
    """One synthesis level along ``axis`` with the crop folded in, routed as
    :func:`idwt_axis_pairs` routes it.

    ``padl = padr = 0`` with a padded mode gives the whole uncropped
    transposed convolution (``periodization``: its circular fold, ``2m``
    samples).
    """
    return idwt_axis_pairs((lo,), (hi,), axis, rec_lo, rec_hi, padl, padr, mode).squeeze(0)


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
    axes = tuple(range(-ndim, 0))
    dense = _dense(data.dtype, dec_lo, dec_hi)
    if dense and all(data.shape[a] <= get_matmul_max_length() for a in axes):
        # one product per axis on the packed bands, sliced at the end
        x = data
        for axis in axes:
            op, aligned = analysis_operator(x.shape[axis], dec_lo, dec_hi, mode, x)
            x = axis_matmul(x, op, axis, aligned)
        halves = [x.shape[a] // 2 for a in axes]
        bands = []
        for bits in SUBBAND_ORDERS[ndim]:
            band = x
            for axis, bit, m in zip(axes, bits, halves):
                band = band.narrow(axis, bit * m, m)
            bands.append(band)
        return tuple(bands)
    if ndim == 1:
        lo, hi = dwt_axis_packed(data, -1, dec_lo, dec_hi, mode).unbind(0)
        return lo, hi
    if ndim == 3:
        packed = data
        for axis in (-3, -2, -1):
            packed = dwt_axis_packed(packed, axis, dec_lo, dec_hi, mode)
        # [2 (w bit), 2 (h bit), 2 (d bit), B, d, h, w]: flat index 4w + 2h
        # + d; one unbind, whose backward stacks the eight cotangents once
        bands = packed.flatten(0, 2).unbind(0)
        return tuple(bands[4 * w + 2 * h + d] for d, h, w in SUBBAND_ORDERS[3])
    h, w = data.shape[-2:]
    if not (dense or filters_traced(dec_lo, dec_hi)) and fused2_analysis_applicable(h, w, len(dec_lo), mode):
        return fused2_dwt_level(data, dec_lo, dec_hi, mode)
    rows = dwt_axis_packed(data, -2, dec_lo, dec_hi, mode)  # [2 (H bit), B, m_h, w]
    both = dwt_axis_packed(rows, -1, dec_lo, dec_hi, mode)  # [2 (W bit), 2, B, m_h, m_w]
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
    axes = tuple(range(-ndim, 0))
    periodization = mode == "periodization"
    dense = _dense(subbands[0].dtype, rec_lo, rec_hi)
    if dense and all(
        _synthesis_out_len(subbands[0].shape[a], len(rec_lo), *pads[ndim + a], periodization)
        <= get_matmul_max_length()
        for a in axes
    ):
        # the bands packed side by side (one copy), then one product per
        # axis with the [out, 2m] operator (wrap and crop folded in)
        x = _packed(dict(zip(SUBBAND_ORDERS[ndim], subbands)), axes)
        for axis in axes:
            m = subbands[0].shape[axis]
            op, aligned = synthesis_operator(m, rec_lo, rec_hi, *pads[ndim + axis], periodization, x)
            x = axis_matmul(x, op, axis, aligned)
        return x
    if ndim == 1:
        lo, hi = subbands
        return idwt_axis_pairs((lo,), (hi,), -1, rec_lo, rec_hi, *pads[0], mode).squeeze(0)
    if ndim == 3:
        # index (d, h, w) -> 4d + 2h + w; pass -1 pairs w = 0 with w = 1
        band = list(subbands)
        lo_h = idwt_axis_pairs(band[0::4], band[1::4], -1, rec_lo, rec_hi, *pads[2], mode)  # (d, h=0)
        hi_h = idwt_axis_pairs(band[2::4], band[3::4], -1, rec_lo, rec_hi, *pads[2], mode)  # (d, h=1)
        d_pair = idwt_axis_pairs(lo_h.unbind(0), hi_h.unbind(0), -2, rec_lo, rec_hi, *pads[1], mode)
        lo, hi = d_pair.unbind(0)
        return idwt_axis_pairs((lo,), (hi,), -3, rec_lo, rec_hi, *pads[0], mode).squeeze(0)
    ll, lh, hl, hh = subbands
    if (
        len({b.shape for b in subbands}) == 1
        and not (dense or filters_traced(rec_lo, rec_hi))
        and fused2_synthesis_applicable(ll.shape[-2], ll.shape[-1], len(rec_lo), mode, pads)
    ):
        return fused2_idwt_level(subbands, rec_lo, rec_hi, mode)
    lo, hi = idwt_axis_pairs((ll, lh), (hl, hh), -1, rec_lo, rec_hi, *pads[1], mode).unbind(0)
    return idwt_axis_pairs((lo,), (hi,), -2, rec_lo, rec_hi, *pads[0], mode).squeeze(0)
