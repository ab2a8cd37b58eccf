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

Gradients: each launch is a custom op (``analysis_axis``,
``synthesis_axis``, and ``tap_grad`` for KT, in ``torch.ops.ptwt_tpu_torch``,
:mod:`._library`), and K3 and K4 are each other's VJP, as K1 and K2 are
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

Second derivatives: every op's backward is ops again, so a gradient
differentiates to any order.  KT is bilinear; its VJP for the ``[2, L]``
cotangent ``c`` of the taps is one K3 launch (the bands' cotangents: the
analysis of ``ext`` with the taps ``c``) and one K4 launch (``ext``'s
cotangent: the transpose of that analysis on the bands), the filter
tensors being ``c`` itself.  The filter gradient of K3's VJP (K4's fold
instance) is one KT launch on its output cotangent.

Each kernel has a plain torch version here (:func:`dwt_axis_plain`,
:func:`idwt_axis_plain`, and for the VJPs :func:`dwt_axis_vjp_plain`,
:func:`idwt_axis_vjp_plain`, for KT :func:`dwt_axis_tap_grad_plain` and
:func:`idwt_axis_tap_grad_plain`, autograd through the former), built on
:mod:`._slices` and the padding gather.  The wrappers take it for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils._padding import fwt_pad, get_pad
from . import _kernels
from ._library import NAMESPACE, autograd, batch_first, call, no_batched
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


def _op_taps(filt: Optional[torch.Tensor], taps: Optional[list[float]]) -> list[float]:
    """An op's taps: the constants it was given, or its filter tensor's
    taps read to the host (one copy; :func:`~._kernels.keep_host_taps`
    may have kept them already)."""
    return taps if filt is None else _kernels.host_taps(filt)


def _as_grad(taps: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """One row of KT's ``[2, L]`` float64 result as ``filt``'s gradient."""
    return taps.to(device=filt.device, dtype=filt.dtype).reshape(filt.shape)


# K3: one analysis level along one axis (also K4's VJP, zero-bounded)


@torch.library.custom_op(f"{NAMESPACE}::analysis_axis", mutates_args=())
def analysis_axis(
    x: torch.Tensor,
    lo_t: Optional[torch.Tensor],
    hi_t: Optional[torch.Tensor],
    lo: Optional[list[float]],
    hi: Optional[list[float]],
    ax: int,
    m: int,
    period: int,
    pad: int,
    code: int,
) -> torch.Tensor:
    """K3 on ``x``: ``[2, ..., m, ...]`` along ``ax`` (:func:`_analysis_kernel`).
    The taps are ``lo``/``hi``, or where given those of the filter tensors
    ``lo_t``/``hi_t`` (a learnable bank, whose gradient is KT's)."""
    return _analysis_kernel(x, ax, _op_taps(lo_t, lo), _op_taps(hi_t, hi), m, period, pad, code)


@analysis_axis.register_fake
def _(x, lo_t, hi_t, lo, hi, ax, m, period, pad, code):
    shape = list(x.shape)
    shape[ax] = m
    return x.new_empty([2, *shape])


def _analysis_setup(ctx, inputs, output):
    x, lo_t, hi_t, lo, hi, ax, m, period, pad, code = inputs
    ctx.plan = (lo, hi, ax, x.shape[ax], period, pad, code)
    # the map is linear in x: it is kept only for the filters' gradient
    ctx.save_for_backward(None if lo_t is None and hi_t is None else x, lo_t, hi_t)


def _analysis_backward(ctx, ct):
    """K3's VJP: K4's fold instance for the input, KT for the filters."""
    lo, hi, ax, n, period, pad, code = ctx.plan
    x, lo_t, hi_t = ctx.saved_tensors
    ct = ct.contiguous()
    grad = None
    if ctx.needs_input_grad[0]:
        grad = call(
            synthesis_axis, [ct[0]], [ct[1]], lo_t, hi_t, lo, hi, ax, n, pad, False, code, period
        )[0]
    g_lo = g_hi = None
    if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
        taps = call(tap_grad, x, [ct[0]], [ct[1]], ax, _filter_len(lo_t, lo), period, pad, code)
        g_lo = _as_grad(taps[0], lo_t) if ctx.needs_input_grad[1] else None
        g_hi = _as_grad(taps[1], hi_t) if ctx.needs_input_grad[2] else None
    return (grad, g_lo, g_hi) + (None,) * 7


@analysis_axis.register_vmap
def _(info, in_dims, x, lo_t, hi_t, lo, hi, ax, m, period, pad, code):
    no_batched("analysis_axis", in_dims, 1, 2)
    x = batch_first(x, in_dims[0], info.batch_size).contiguous()
    return analysis_axis(x, lo_t, hi_t, lo, hi, ax + 1, m, period, pad, code), 1


# K4: one synthesis level along one axis for up to two (lo, hi) pairs
# (also K3's VJP, the fold instance)


@torch.library.custom_op(f"{NAMESPACE}::synthesis_axis", mutates_args=())
def synthesis_axis(
    los: list[torch.Tensor],
    his: list[torch.Tensor],
    lo_t: Optional[torch.Tensor],
    hi_t: Optional[torch.Tensor],
    lo: Optional[list[float]],
    hi: Optional[list[float]],
    ax: int,
    out_len: int,
    off: int,
    circular: bool,
    fold: int,
    period: int,
) -> torch.Tensor:
    """K4 on the pairs: ``[G, ..., out_len, ...]`` (:func:`_synthesis_kernel`;
    ``fold``/``period`` make it K3's VJP).  Taps as :func:`analysis_axis`'s."""
    return _synthesis_kernel(
        los, his, ax, _op_taps(lo_t, lo), _op_taps(hi_t, hi), out_len, off, circular, fold, period
    )


@synthesis_axis.register_fake
def _(los, his, lo_t, hi_t, lo, hi, ax, out_len, off, circular, fold, period):
    shape = list(los[0].shape)
    shape[ax] = out_len
    return los[0].new_empty([len(los), *shape])


def _synthesis_setup(ctx, inputs, output):
    los, his, lo_t, hi_t, lo, hi, ax, out_len, off, circular, fold, period = inputs
    ctx.plan = (lo, hi, ax, los[0].shape[ax], off, circular, fold, period)
    ctx.groups = len(los)
    bands = (*los, *his) if lo_t is not None or hi_t is not None else ()
    ctx.save_for_backward(lo_t, hi_t, *bands)


def _synthesis_backward(ctx, ct):
    """K4's VJP: K3 for the bands (the rec taps, ``pad = off``, the
    cotangent read zero outside its length, modulo ``2m`` for
    ``periodization``), KT for the filters, summed over the pairs.  The
    fold instance's VJP is K3 itself with its mode and period, and its
    filters' gradient (a mixed second derivative, ``d/dtaps`` of an input
    gradient) KT on the output cotangent with K3's geometry (``pad =
    off``, the mode ``fold``)."""
    lo, hi, ax, m, off, circular, fold, period = ctx.plan
    lo_t, hi_t, *bands = ctx.saved_tensors
    g = ctx.groups
    ct = ct.contiguous()
    if fold != _ZERO:
        code = fold
    elif circular:
        period, code = 2 * m, _WRAP_ZERO
    else:
        period, code = ct.shape[ax + 1], _ZERO
    # the fold instance's cotangent is shaped like K3's input: one group,
    # along ax itself
    ext, ext_ax = (ct[0], ax) if fold != _ZERO else (ct, ax + 1)
    band_grads = ([None] * g, [None] * g)
    if any(ctx.needs_input_grad[0]) or any(ctx.needs_input_grad[1]):
        grads = call(analysis_axis, ext, lo_t, hi_t, lo, hi, ext_ax, m, period, off, code)
        if fold != _ZERO:
            grads = grads.unsqueeze(1)
        band_grads = (list(grads[0].unbind(0)), list(grads[1].unbind(0)))
    g_lo = g_hi = None
    if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
        taps = call(
            tap_grad, ext, bands[:g], bands[g:], ext_ax, _filter_len(lo_t, lo), period, off, code
        )
        g_lo = _as_grad(taps[0], lo_t) if ctx.needs_input_grad[2] else None
        g_hi = _as_grad(taps[1], hi_t) if ctx.needs_input_grad[3] else None
    return (*band_grads, g_lo, g_hi) + (None,) * 8


@synthesis_axis.register_vmap
def _(info, in_dims, los, his, lo_t, hi_t, lo, hi, ax, out_len, off, circular, fold, period):
    no_batched("synthesis_axis", in_dims, 2, 3)
    size = info.batch_size
    los = [batch_first(t, d, size).contiguous() for t, d in zip(los, in_dims[0] or [None] * len(los))]
    his = [batch_first(t, d, size).contiguous() for t, d in zip(his, in_dims[1] or [None] * len(his))]
    out = synthesis_axis(los, his, lo_t, hi_t, lo, hi, ax + 1, out_len, off, circular, fold, period)
    return out, 1


# KT: the taps' gradient of a K3 or K4 launch


@torch.library.custom_op(f"{NAMESPACE}::tap_grad", mutates_args=())
def tap_grad(
    ext: torch.Tensor,
    los: list[torch.Tensor],
    his: list[torch.Tensor],
    ax: int,
    n_taps: int,
    period: int,
    pad: int,
    code: int,
) -> torch.Tensor:
    """KT: the ``[2, n_taps]`` float64 gradient of the lo and hi taps
    (:func:`_tap_grad_kernel`)."""
    return _tap_grad_kernel(ext, ax, los, his, n_taps, period, pad, code)


@tap_grad.register_fake
def _(ext, los, his, ax, n_taps, period, pad, code):
    return ext.new_empty([2, n_taps], dtype=torch.float64)


@tap_grad.register_vmap
def _(info, in_dims, ext, los, his, ax, n_taps, period, pad, code):
    # KT sums over every row; per-sample filter gradients are no one launch
    no_batched("tap_grad", in_dims, 0, 1, 2)
    return tap_grad(ext, los, his, ax, n_taps, period, pad, code), None


def _filter_len(filt: Optional[torch.Tensor], taps: Optional[list[float]]) -> int:
    return len(taps) if filt is None else filt.shape[-1]


def _tap_grad_setup(ctx, inputs, output):
    ext, los, his, ax, n_taps, period, pad, code = inputs
    ctx.plan = (ax, ext.shape[ax], period, pad, code)
    ctx.groups = len(los)
    ctx.save_for_backward(ext, *los, *his)


def _tap_grad_backward(ctx, c):
    """KT's VJP for the ``[2, n_taps]`` cotangent ``c`` of the taps
    (``g_f[k] = sum band_f[j] ext[src(2j + k - pad)]`` is bilinear): the
    bands' cotangents are K3 on ``ext`` with the taps ``c`` (one launch
    for every group), ``ext``'s is that analysis transposed on the bands,
    one K4 launch: the zero-bounded instance for the zero mode, the
    circular one for ``periodization``'s cotangent (modulo ``2m``), the
    fold instance for K3's other modes.  ``c`` goes in as the ops' filter
    tensors, read to the host once."""
    ax, n, period, pad, code = ctx.plan
    ext, *bands = ctx.saved_tensors
    g = ctx.groups
    los, his = bands[:g], bands[g:]
    grouped = ext.ndim > los[0].ndim
    m = los[0].shape[ax - grouped]
    c_lo, c_hi = c.unbind(0)
    _kernels.keep_host_taps([c_lo, c_hi])
    band_grads = ([None] * g, [None] * g)
    if any(ctx.needs_input_grad[1]) or any(ctx.needs_input_grad[2]):
        grads = call(analysis_axis, ext.contiguous(), c_lo, c_hi, None, None, ax, m, period, pad, code)
        if not grouped:
            grads = grads.unsqueeze(1)
        band_grads = (list(grads[0].unbind(0)), list(grads[1].unbind(0)))
    grad = None
    if ctx.needs_input_grad[0]:
        band_ax = ax - grouped
        if code == _ZERO or (code == _WRAP_ZERO and period == 2 * m):
            grad = call(
                synthesis_axis, los, his, c_lo, c_hi, None, None,
                band_ax, n, pad, code == _WRAP_ZERO, _ZERO, 0,
            )
        elif g == 1:
            grad = call(synthesis_axis, los, his, c_lo, c_hi, None, None, band_ax, n, pad, False, code, period)
        else:
            raise NotImplementedError(
                f"KT's VJP: K4's fold instance takes one (lo, hi) pair, this launch had {g}"
            )
        if not grouped:
            grad = grad[0]
    return grad, *band_grads, None, None, None, None, None


autograd(analysis_axis, _analysis_setup, _analysis_backward)
autograd(synthesis_axis, _synthesis_setup, _synthesis_backward)
autograd(tap_grad, _tap_grad_setup, _tap_grad_backward)


def _filter_input(filt):
    """A filter as an op's input: the tensor, or ``None`` for a constant
    bank (tuples, numpy), whose taps the op takes as floats."""
    return filt if isinstance(filt, torch.Tensor) else None


def _constant_taps(filt) -> Optional[list[float]]:
    """A constant bank's taps as floats; None for a filter tensor, whose
    taps the op reads itself."""
    return None if isinstance(filt, torch.Tensor) else _kernels.host_taps(filt)


def _tap_runs(filt_len: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of the taps each K3/K4 launch of one level takes:
    the whole bank, or for a bank longer than ``PTWT_MAX_TAPS``
    (:data:`~._kernels.MAX_TAPS`; the kernel-parameter bank holds no
    more) runs of at most that many taps, of one even length but the
    last, so that each run starts on an even tap."""
    if filt_len <= _kernels.MAX_TAPS:
        return [(0, filt_len)]
    runs = -(-filt_len // _kernels.MAX_TAPS)
    size = 2 * -(-filt_len // (2 * runs))
    return [(start, min(start + size, filt_len)) for start in range(0, filt_len, size)]


def pallas_dwt_axis(
    x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str
) -> torch.Tensor:
    """One analysis level along ``axis``, packed as ``[2, ...]`` (lo, hi).

    ``dec_lo``/``dec_hi`` are flipped (correlation order), as
    ``get_filter_arrays(..., flip=True)`` returns them.  A CPU tensor runs
    :func:`dwt_axis_plain`; a CUDA tensor runs K3 on the unpadded input,
    every mode's extension applied by the kernel, and filters that
    require grad get theirs from KT.  A bank longer than the kernel takes
    runs as one K3 launch per run of taps (:func:`_tap_runs`), summed: the
    run from tap ``2s`` gives band ``i`` what the whole bank's band ``i``
    reads from ``2 (i + s) + k - pad``, so it launches ``m + s`` bands and
    keeps the last ``m``.
    """
    if _on_cpu(x):
        return torch.stack(dwt_axis_plain(x, axis, dec_lo, dec_hi, mode))
    ax = axis % x.ndim
    m, period, pad, code = _analysis_plan(x.shape[ax], len(dec_lo), mode)
    x = x.contiguous()
    out = None
    for start, stop in _tap_runs(len(dec_lo)):
        lo, hi = (dec_lo, dec_hi) if stop - start == len(dec_lo) else (dec_lo[start:stop], dec_hi[start:stop])
        skip = start // 2
        part = call(
            analysis_axis, x, _filter_input(lo), _filter_input(hi),
            _constant_taps(lo), _constant_taps(hi), ax, m + skip, period, pad, code,
        )
        part = part.narrow(ax + 1, skip, m) if skip else part
        out = part if out is None else out + part
    return out


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
    pairs (at most two).  A bank longer than the kernel takes runs as one
    K4 launch per run of taps (:func:`_tap_runs`), summed: output ``u``
    of the run from tap ``t`` reads tap ``u + off - t - 2j`` of it, so it
    launches with ``off - t``; where that is negative, for
    ``periodization`` (whose bands repeat) with ``off - t`` modulo ``2m``,
    else with ``0``, its outputs placed ``t - off`` later.
    """
    if _on_cpu(los[0]):
        return torch.stack(
            [
                idwt_axis_plain(a, b, axis, rec_lo, rec_hi, padl, padr, mode)
                for a, b in zip(los, his)
            ]
        )
    filt_len = len(rec_lo)
    ax = axis % los[0].ndim
    m = los[0].shape[ax]
    los = [b.contiguous() for b in los]
    his = [b.contiguous() for b in his]
    circular = mode == "periodization"
    if circular:
        off = padl + filt_len // 2 - 1
        out_len = 2 * m - padl - padr
    else:
        off = padl
        out_len = 2 * (m - 1) + filt_len - padl - padr
    out_len = max(out_len, 0)
    out = None
    for start, stop in _tap_runs(filt_len):
        lo, hi = (rec_lo, rec_hi) if stop - start == filt_len else (rec_lo[start:stop], rec_hi[start:stop])
        shift = off - start
        if circular and m and shift < 0:
            shift %= 2 * m
        later = max(-shift, 0)
        if out is not None and later >= out_len:
            continue  # the run reaches no output
        part = call(
            synthesis_axis, los, his, _filter_input(lo), _filter_input(hi),
            _constant_taps(lo), _constant_taps(hi),
            ax, out_len - later, max(shift, 0), circular, _ZERO, 0,
        )
        if later:
            front = list(part.shape)
            front[ax + 1] = later
            part = torch.cat((part.new_zeros(front), part), dim=ax + 1)
        out = part if out is None else out + part
    return out
