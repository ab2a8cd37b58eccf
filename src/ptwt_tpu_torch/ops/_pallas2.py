"""One filter-bank level along one axis: kernels K3/K4 and their glue.

Counterpart of :mod:`ptwt_tpu.ops._pallas2` (the module and its public
functions keep their names so each has its counterpart under the same
name).  There, XLA pads and phase-splits the signal and two Pallas tap
stencils do the arithmetic; here two hand-written CUDA kernels
(``csrc/axis.cu``) stage shared-memory tiles straight from the unpadded
source:

* **K3** (``_analysis_kernel``) — ``lo[i] = sum_k dec~[k] ext[2i+k-pad]``
  and the same for ``hi``.  Every boundary mode is applied while the
  window is staged, as pywt's source-index map of the unpadded axis
  (:func:`~ptwt_tpu_torch.utils._padding.source_index`): no padded copy
  is made in any mode, periodic bands come out whole (wrap entries
  included), and odd ``periodization`` axes repeat their last sample.
* **K4** (``_synthesis_kernel``) — both output phases of the stride-2
  transposed convolution with the crop folded into its index range;
  circular for ``periodization``.  Up to two (lo, hi) pairs of one shape
  go through one launch, so a 2d level needs no stacking copy.

Gradients: one :class:`torch.autograd.Function` per direction wraps each
launch, and K3 and K4 are each other's VJP, as K1 and K2 are
(``csrc/axis.cu``), so no atomics and one summation order:

* K3's VJP (the contract of ``_analysis_transpose_kernel``) is K4 with
  the dec taps and ``off = pad`` in its fold instance: each output also
  collects the extended positions K3 read from it (pywt's extension
  transposed), so the input's cotangent comes back directly.  It counts
  as a K4 launch.
* K4's VJP (``_synthesis_transpose_kernel``) is K3 with the rec taps,
  ``pad = off`` and the cotangent read zero outside its length (modulo
  ``2m`` for ``periodization``), every (lo, hi) pair of the launch at
  once.  It counts as a K3 launch.

Filter gradients: the Functions take the filter tensors as inputs (their
taps still reach the kernels as constants, read to the host once per
transform call).  Where autograd asks for a filter's gradient, the
backward also launches **KT** (``_tap_grad_kernel``, ``csrc/axis.cu``;
no Pallas counterpart: the JAX package differentiates its slices route
instead), one launch per Function for both filters:

* K3's taps: ``g_f[k] = sum ct_f[j] x[src(2j + k - pad)]`` over the
  level's input extended by its mode, as K3 stages it;
* K4's taps: ``g_f[k] = sum band_f[j] ct[2j + k - off]`` over the output
  cotangent in the uncropped frame (zero outside it; modulo ``2m`` for
  ``periodization``), summed over the launch's (lo, hi) pairs.

Double backward raises.

Each kernel has a plain torch version here (:func:`dwt_axis_plain`,
:func:`idwt_axis_plain`, and for the VJPs :func:`dwt_axis_vjp_plain`,
:func:`idwt_axis_vjp_plain`, for KT :func:`dwt_axis_tap_grad_plain` and
:func:`idwt_axis_tap_grad_plain`, autograd through the former), built on
:mod:`._slices` and the padding gather.  The wrappers take it for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils._padding import fwt_pad, get_pad
from . import _kernels
from ._conv import periodization_wrap
from ._slices import analysis_slices_lastaxis, synthesis_slices_lastaxis

__all__ = [
    "dwt_axis_plain",
    "dwt_axis_tap_grad_plain",
    "dwt_axis_vjp_plain",
    "idwt_axis_plain",
    "idwt_axis_tap_grad_plain",
    "idwt_axis_vjp_plain",
    "pallas_dwt_axis",
    "pallas_idwt_axis",
]


def _std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


# How K3 reads a position outside the axis (the AXIS_* codes of
# csrc/axis.cu): zero, edge (pywt's "constant"), the two mirrors, modulo
# the period with the odd-axis repeat (periodic, periodization), and
# modulo the period with zeros past the axis (the VJP of K4's
# periodization).
_ZERO, _CONSTANT, _SYMMETRIC, _REFLECT, _WRAP, _WRAP_ZERO = range(6)
_MODE_CODE = {
    "zero": _ZERO,
    "valid": _ZERO,
    "constant": _CONSTANT,
    "symmetric": _SYMMETRIC,
    "reflect": _REFLECT,
    "periodic": _WRAP,
    "periodization": _WRAP,
}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: use a CPU or CUDA tensor")
    return False


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def dwt_axis_plain(
    x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis level along ``axis`` in plain torch ops; ``(lo, hi)``.

    ``dec_lo``/``dec_hi`` are flipped (correlation order).  ``valid``
    means the caller padded the data already.
    """
    filt_len = len(dec_lo)
    padded = x if mode == "valid" else fwt_pad(x, filt_len, mode=mode, axes=(axis,))
    lo, hi = analysis_slices_lastaxis(padded.movedim(axis, -1), dec_lo, dec_hi)
    return lo.movedim(-1, axis), hi.movedim(-1, axis)


def idwt_axis_plain(
    lo: torch.Tensor,
    hi: torch.Tensor,
    axis: int,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
    mode: str,
) -> torch.Tensor:
    """One synthesis level along ``axis`` in plain torch ops, cropped by
    ``padl``/``padr``; ``periodization`` wrap-adds the overhang."""
    filt_len = len(rec_lo)
    out = synthesis_slices_lastaxis(
        lo.movedim(axis, -1), hi.movedim(axis, -1), rec_lo, rec_hi
    )
    if mode == "periodization":
        out = periodization_wrap(out, axis=-1, filt_len=filt_len)
    out = out[..., padl : out.shape[-1] - padr]
    return out.movedim(-1, axis)


def dwt_axis_vjp_plain(
    x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str, ct: torch.Tensor
) -> torch.Tensor:
    """VJP of :func:`dwt_axis_plain` at ``x`` for the packed cotangent
    ``ct`` (``[2, ...]``, lo then hi): the plain version of K3's VJP."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        lo, hi = dwt_axis_plain(x, axis, dec_lo, dec_hi, mode)
        (grad,) = torch.autograd.grad((lo, hi), x, (ct[0], ct[1]))
    return grad


def idwt_axis_vjp_plain(
    lo: torch.Tensor,
    hi: torch.Tensor,
    axis: int,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
    mode: str,
    ct: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """VJP of :func:`idwt_axis_plain` for the output cotangent ``ct``:
    ``(lo_bar, hi_bar)``, the plain version of K4's VJP."""
    with torch.enable_grad():
        lo = lo.detach().requires_grad_()
        hi = hi.detach().requires_grad_()
        out = idwt_axis_plain(lo, hi, axis, rec_lo, rec_hi, padl, padr, mode)
        grads = torch.autograd.grad(out, (lo, hi), ct)
    return grads[0], grads[1]


def _leaf_filter(filt, ref: torch.Tensor) -> torch.Tensor:
    if not isinstance(filt, torch.Tensor):
        filt = torch.as_tensor(np.asarray(filt, dtype=np.float64))
    return filt.detach().to(device=ref.device, dtype=ref.dtype).requires_grad_()


def _filter_grads(outs, filters, cts) -> tuple:
    grads = torch.autograd.grad(outs, filters, cts, allow_unused=True)
    return tuple(torch.zeros_like(f) if g is None else g for g, f in zip(grads, filters))


def dwt_axis_tap_grad_plain(
    x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str, ct: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`dwt_axis_plain` with respect to its (flipped)
    filters for the packed cotangent ``ct``: the plain version of KT for
    K3's taps, ``(g_lo, g_hi)`` in ``x``'s dtype."""
    with torch.enable_grad():
        lo_f, hi_f = _leaf_filter(dec_lo, x), _leaf_filter(dec_hi, x)
        lo, hi = dwt_axis_plain(x.detach(), axis, lo_f, hi_f, mode)
        return _filter_grads((lo, hi), (lo_f, hi_f), (ct[0], ct[1]))


def idwt_axis_tap_grad_plain(
    los: Sequence[torch.Tensor],
    his: Sequence[torch.Tensor],
    axis: int,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
    mode: str,
    ct: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`idwt_axis_plain` on each (lo, hi) pair with
    respect to its filters for the stacked cotangent ``ct`` (``[G,
    ...]``), summed over the pairs: the plain version of KT for K4's
    taps, ``(g_lo, g_hi)``."""
    with torch.enable_grad():
        lo_f, hi_f = _leaf_filter(rec_lo, ct), _leaf_filter(rec_hi, ct)
        outs = [
            idwt_axis_plain(a.detach(), b.detach(), axis, lo_f, hi_f, padl, padr, mode)
            for a, b in zip(los, his)
        ]
        return _filter_grads(outs, (lo_f, hi_f), list(ct.unbind(0)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

#: Rows of KT's scratch: the most blocks of its first launch, which runs as
#: many as fit on the card at once (an H100 holds at most 32 blocks on each
#: of its 132 SMs), so the order of its sums depends on the shapes and the
#: device.
TAP_BLOCKS = 32 * 132


def _outer_inner(shape: Sequence[int], ax: int) -> tuple[int, int]:
    return math.prod(shape[:ax]), math.prod(shape[ax + 1 :])


def _analysis_plan(n: int, filt_len: int, mode: str) -> tuple[int, int, int, int]:
    """``(m, period, pad, code)`` of K3 on an unpadded axis of ``n``."""
    if mode == "periodization":
        # odd axes repeat their last sample (pywt's edge pad to even); an
        # odd-length bank gives period / 2 - 1 bands, as the padded
        # convolution of the plain version does
        period = n + n % 2
        pad = filt_len // 2 - 1
        return (period + 2 * pad - filt_len) // 2 + 1, period, pad, _WRAP
    if mode == "valid":
        return max((n - filt_len) // 2 + 1, 0), n, 0, _ZERO
    if mode not in _MODE_CODE:
        raise ValueError(f"Padding mode not supported: {mode}")
    # pywt's extension, one extra sample on the right of odd axes; the
    # periodic band's wrap entries come out of the same modulo read
    padl, padr = get_pad(n, filt_len)
    return max((n + padl + padr - filt_len) // 2 + 1, 0), n, padl, _MODE_CODE[mode]


def _analysis_kernel(
    x: torch.Tensor, ax: int, lo, hi, m: int, period: int, pad: int, code: int
) -> torch.Tensor:
    """Launch K3 on ``x`` viewed as ``[outer, n, inner]`` -> ``[2, ..., m, ...]``:
    band ``i`` reads positions ``2i + k - pad``, mapped by ``code``."""
    _kernels.check_tensor("x", x, x.dtype, x.device)
    n = x.shape[ax]
    outer, inner = _outer_inner(x.shape, ax)
    shape = list(x.shape)
    shape[ax] = m
    out = torch.empty([2, *shape], dtype=x.dtype, device=x.device)
    if not out.numel():
        return out
    if not n:  # an empty axis reads zeros
        return out.zero_()
    _kernels.launch(
        "K3", "ptwt_analysis_axis", x.device, x.dtype,
        x, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
        outer, n, period, m, inner, pad, code,
    )
    return out


def _synthesis_kernel(
    los: Sequence[torch.Tensor],
    his: Sequence[torch.Tensor],
    ax: int,
    lo,
    hi,
    out_len: int,
    off: int,
    circular: bool,
    fold: int = _ZERO,
    period: int = 0,
) -> torch.Tensor:
    """Launch K4 on up to two (lo, hi) pairs -> ``[G, ..., out_len, ...]``.

    ``fold``/``period`` make it K3's VJP (one pair): each output ``u``
    also collects the positions outside ``[0, out_len)`` that the mode
    ``fold`` maps onto ``u``."""
    ref = los[0]
    if not 1 <= len(los) == len(his) <= 2:
        raise ValueError("K4 takes one or two (lo, hi) pairs")
    for name, t in [("lo", b) for b in los] + [("hi", b) for b in his]:
        _kernels.check_tensor(name, t, ref.dtype, ref.device)
        if t.shape != ref.shape:
            raise ValueError(f"all bands must share one shape, got {t.shape} and {ref.shape}")
    m = ref.shape[ax]
    outer, inner = _outer_inner(ref.shape, ax)
    shape = list(ref.shape)
    shape[ax] = out_len
    out = torch.empty([len(los), *shape], dtype=ref.dtype, device=ref.device)
    if not out.numel():
        return out
    if not m:  # no band rows: every output reads zeros
        return out.zero_()
    pair1 = (los[-1], his[-1])
    _kernels.launch(
        "K4", "ptwt_synthesis_axis", ref.device, ref.dtype,
        los[0], his[0], pair1[0], pair1[1], len(los), out,
        _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
        outer, m, out_len, inner, off, int(circular), fold, period,
    )
    return out


def _analysis_transpose_kernel(
    ct: torch.Tensor, ax: int, n: int, lo, hi, period: int, pad: int, code: int
) -> torch.Tensor:
    """K3's VJP: the ``[2, ..., m, ...]`` cotangent of a K3 launch -> the
    cotangent of its ``[..., n, ...]`` input, as one launch of K4's fold
    instance (dec taps, ``off = pad``), counted as K4."""
    return _synthesis_kernel(
        [ct[0]], [ct[1]], ax, lo, hi, n, pad, False, fold=code, period=period
    )[0]


def _synthesis_transpose_kernel(
    ct: torch.Tensor, ax: int, m: int, lo, hi, off: int, circular: bool
) -> torch.Tensor:
    """K4's VJP: the ``[G, ..., out_len, ...]`` cotangent of a K4 launch
    -> ``[2, G, ..., m, ...]``, each pair's (lo, hi) cotangents, as one
    launch of K3 with the rec taps and ``pad = off``, counted as K3.  The
    cotangent reads zero outside its length, for ``periodization`` modulo
    ``2m`` and zero past it."""
    if circular:
        return _analysis_kernel(ct, ax + 1, lo, hi, m, 2 * m, off, _WRAP_ZERO)
    return _analysis_kernel(ct, ax + 1, lo, hi, m, ct.shape[ax + 1], off, _ZERO)


def _tap_grad_kernel(
    ext: torch.Tensor,
    ax: int,
    los: Sequence[torch.Tensor],
    his: Sequence[torch.Tensor],
    n_taps: int,
    period: int,
    pad: int,
    code: int,
) -> torch.Tensor:
    """Launch KT -> the ``[2, n_taps]`` float64 gradient of the lo and hi
    taps: ``g_f[k] = sum band_f[j] ext[src(2j + k - pad)]`` over every row,
    band position ``j`` and column, ``src`` being K3's map of ``code`` on
    ``ext``'s axis ``ax`` (K3's taps: ``ext`` the level's input, the bands
    its output cotangents; K4's taps: ``ext`` the ``[G, ...]`` output
    cotangent, pair ``g``'s bands under group ``g``)."""
    ref = los[0]
    _kernels.check_tensor("ext", ext, ref.dtype, ref.device)
    for name, t in [("lo", b) for b in los] + [("hi", b) for b in his]:
        _kernels.check_tensor(name, t, ref.dtype, ref.device)
        if t.shape != ref.shape:
            raise ValueError(f"all bands must share one shape, got {t.shape} and {ref.shape}")
    groups = len(los)
    n = ext.shape[ax]
    m = ref.shape[ax - (ext.ndim - ref.ndim)]
    outer, inner = _outer_inner(ext.shape, ax)
    if not (ref.numel() and n):  # no products: a zero gradient
        return torch.zeros([2, n_taps], dtype=torch.float64, device=ref.device)
    out = torch.empty([2, n_taps], dtype=torch.float64, device=ref.device)
    partial = torch.empty([TAP_BLOCKS, 2 * n_taps], dtype=torch.float64, device=ref.device)
    pair1 = (los[-1], his[-1])
    _kernels.launch(
        "KT", "ptwt_tap_grad", ref.device, ref.dtype,
        ext, los[0], his[0], pair1[0], pair1[1], groups, out, partial, TAP_BLOCKS, n_taps,
        outer // groups, n, period, m, inner, pad, code,
    )
    return out


def _filter_meta(*filts) -> tuple:
    return tuple(None if f is None else (f.device, f.dtype, f.shape) for f in filts)


def _as_grads(taps: torch.Tensor, metas, needs) -> tuple:
    """KT's ``[2, L]`` float64 result as the gradients of the filter
    tensors described by ``metas`` (``None`` where autograd asks for
    none)."""
    return tuple(
        taps[i].to(device=meta[0], dtype=meta[1]).reshape(meta[2]) if need else None
        for i, (meta, need) in enumerate(zip(metas, needs))
    )


class _AnalysisAxis(torch.autograd.Function):
    """K3 forward; backward K4's fold instance for the input and KT for the
    filter tensors ``lo_t``/``hi_t`` (``None`` for constant banks).  The
    input is saved only where a filter needs its gradient: the map is
    linear in it."""

    @staticmethod
    def forward(ctx, x, lo_t, hi_t, ax, lo, hi, m, period, pad, code):
        ctx.plan = (ax, x.shape[ax], lo, hi, period, pad, code)
        ctx.filters = _filter_meta(lo_t, hi_t)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ctx.save_for_backward(x)
        return _analysis_kernel(x, ax, lo, hi, m, period, pad, code)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        ct = ct.contiguous()
        grad = _analysis_transpose_kernel(ct, *ctx.plan) if ctx.needs_input_grad[0] else None
        filter_grads = (None, None)
        needs = ctx.needs_input_grad[1:3]
        if any(needs):
            (x,) = ctx.saved_tensors
            ax, _, lo, _, period, pad, code = ctx.plan
            taps = _tap_grad_kernel(x, ax, [ct[0]], [ct[1]], len(lo), period, pad, code)
            filter_grads = _as_grads(taps, ctx.filters, needs)
        return (grad, *filter_grads) + (None,) * 7


class _SynthesisAxis(torch.autograd.Function):
    """K4 forward on ``G`` (lo, hi) pairs; backward K3 (zero-bounded) for
    the bands and KT for the filter tensors, summed over the pairs."""

    @staticmethod
    def forward(ctx, lo_t, hi_t, ax, lo, hi, out_len, off, circular, *bands):
        groups = len(bands) // 2
        ctx.plan = (ax, bands[0].shape[ax], lo, hi, off, circular)
        ctx.groups = groups
        ctx.filters = _filter_meta(lo_t, hi_t)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(*bands)
        return _synthesis_kernel(
            bands[:groups], bands[groups:], ax, lo, hi, out_len, off, circular
        )

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        ct = ct.contiguous()
        band_grads = (None,) * (2 * ctx.groups)
        if any(ctx.needs_input_grad[8:]):
            grads = _synthesis_transpose_kernel(ct, *ctx.plan)
            band_grads = tuple(grads[0]) + tuple(grads[1])
        filter_grads = (None, None)
        needs = ctx.needs_input_grad[:2]
        if any(needs):
            bands = ctx.saved_tensors
            ax, m, lo, _, off, circular = ctx.plan
            period, code = (2 * m, _WRAP_ZERO) if circular else (ct.shape[ax + 1], _ZERO)
            g = ctx.groups
            taps = _tap_grad_kernel(ct, ax + 1, bands[:g], bands[g:], len(lo), period, off, code)
            filter_grads = _as_grads(taps, ctx.filters, needs)
        return (*filter_grads,) + (None,) * 6 + band_grads


def _filter_input(filt):
    """A filter as an input of the Functions: the tensor, or ``None`` for a
    constant bank (numpy, lists)."""
    return filt if isinstance(filt, torch.Tensor) else None


def pallas_dwt_axis(
    x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str
) -> torch.Tensor:
    """One analysis level along ``axis``, packed as ``[2, ...]`` (lo, hi).

    ``dec_lo``/``dec_hi`` are flipped (correlation order), as
    ``get_filter_arrays(..., flip=True)`` returns them.  A CPU tensor runs
    :func:`dwt_axis_plain`; a CUDA tensor runs K3 on the unpadded input,
    every mode's extension applied by the kernel, and filters that
    require grad get theirs from KT.
    """
    if _on_cpu(x):
        return torch.stack(dwt_axis_plain(x, axis, dec_lo, dec_hi, mode))
    lo = _kernels.host_taps(dec_lo)
    hi = _kernels.host_taps(dec_hi)
    ax = axis % x.ndim
    m, period, pad, code = _analysis_plan(x.shape[ax], len(lo), mode)
    return _AnalysisAxis.apply(
        x.contiguous(), _filter_input(dec_lo), _filter_input(dec_hi), ax, lo, hi, m, period, pad, code
    )


def pallas_idwt_axis(
    los: Sequence[torch.Tensor],
    his: Sequence[torch.Tensor],
    axis: int,
    rec_lo,
    rec_hi,
    padl: int,
    padr: int,
    mode: str,
) -> torch.Tensor:
    """One synthesis level along ``axis`` for each (lo, hi) pair.

    Returns the pairs' outputs stacked as ``[G, ...]``.  Unflipped
    reconstruction filters; ``padl``/``padr`` crop the transposed
    convolution (``periodization``: its circular fold).  A CPU tensor runs
    :func:`idwt_axis_plain`; a CUDA tensor runs K4, one launch for all
    pairs (at most two).
    """
    if _on_cpu(los[0]):
        return torch.stack(
            [
                idwt_axis_plain(a, b, axis, rec_lo, rec_hi, padl, padr, mode)
                for a, b in zip(los, his)
            ]
        )
    lo = _kernels.host_taps(rec_lo)
    hi = _kernels.host_taps(rec_hi)
    filt_len = len(lo)
    ax = axis % los[0].ndim
    m = los[0].shape[ax]
    los = [b.contiguous() for b in los]
    his = [b.contiguous() for b in his]
    if mode == "periodization":
        off = padl + filt_len // 2 - 1
        out_len = 2 * m - padl - padr
    else:
        off = padl
        out_len = 2 * (m - 1) + filt_len - padl - padr
    return _SynthesisAxis.apply(
        _filter_input(rec_lo), _filter_input(rec_hi),
        ax, lo, hi, max(out_len, 0), off, mode == "periodization", *los, *his,
    )
