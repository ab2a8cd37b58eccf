"""One filter-bank level along one axis: kernels K3/K4 and their glue.

Counterpart of :mod:`ptwt_tpu.ops._pallas2` (the module and its public
functions keep their names so each has its counterpart under the same
name).  There, XLA pads and phase-splits the signal and two Pallas tap
stencils do the arithmetic; here two hand-written CUDA kernels
(``csrc/axis.cu``) read the strided source directly:

* **K3** (``_analysis_kernel``) — ``lo[i] = sum_k dec~[k] ext[2i+k-pad]``
  and the same for ``hi``.  For the circular modes (``periodization``,
  and ``periodic`` at any length) it reads modulo the period, so neither
  a padded copy nor the wrap copy of the periodic band is made, and odd
  ``periodization`` axes repeat their last sample through the same index
  map.  The other modes are padded first by an index gather
  (:func:`~ptwt_tpu_torch.utils.fwt_pad`).
* **K4** (``_synthesis_kernel``) — both output phases of the stride-2
  transposed convolution with the crop folded into its index range;
  circular for ``periodization``.  Up to two (lo, hi) pairs of one shape
  go through one launch, so a 2d level needs no stacking copy.

Gradients: one :class:`torch.autograd.Function` per direction wraps each
launch, and its backward launches the transposed kernel
(``csrc/axis_vjp.cu``), as the JAX package's ``custom_vjp``s do:

* **K3T** (``_analysis_transpose_kernel``) — the VJP of K3, in gather
  form over the positions K3 read (several periods for a long filter on
  a short axis).  For the padded modes it yields the padded signal's
  cotangent; torch's own backward of the padding gather takes it home.
* **K4T** (``_synthesis_transpose_kernel``) — the VJP of K4, every
  (lo, hi) pair of the launch at once.

Data gradients run on the card; a filter tensor that requires grad
raises there (the kernels take taps as constants).  Double backward
raises too.

Each kernel has a plain torch version here (:func:`dwt_axis_plain`,
:func:`idwt_axis_plain`, and for the VJPs :func:`dwt_axis_vjp_plain`,
:func:`idwt_axis_vjp_plain`, autograd through the former), built on
:mod:`._slices`.  The wrappers take it for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from ..utils._padding import fwt_pad
from . import _kernels
from ._conv import periodization_wrap
from ._slices import analysis_slices_lastaxis, synthesis_slices_lastaxis

__all__ = [
    "dwt_axis_plain",
    "dwt_axis_vjp_plain",
    "idwt_axis_plain",
    "idwt_axis_vjp_plain",
    "pallas_dwt_axis",
    "pallas_idwt_axis",
]


def _std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


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
    ``ct`` (``[2, ...]``, lo then hi): the plain version of K3T."""
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
    ``(lo_bar, hi_bar)``, the plain version of K4T."""
    with torch.enable_grad():
        lo = lo.detach().requires_grad_()
        hi = hi.detach().requires_grad_()
        out = idwt_axis_plain(lo, hi, axis, rec_lo, rec_hi, padl, padr, mode)
        grads = torch.autograd.grad(out, (lo, hi), ct)
    return grads[0], grads[1]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _outer_inner(shape: Sequence[int], ax: int) -> tuple[int, int]:
    return math.prod(shape[:ax]), math.prod(shape[ax + 1 :])


def _analysis_kernel(
    x: torch.Tensor, ax: int, lo, hi, m: int, period: int, pad: int, circular: bool
) -> torch.Tensor:
    """Launch K3 on ``x`` viewed as ``[outer, n, inner]`` -> ``[2, ..., m, ...]``."""
    _kernels.check_tensor("x", x, x.dtype, x.device)
    n = x.shape[ax]
    outer, inner = _outer_inner(x.shape, ax)
    shape = list(x.shape)
    shape[ax] = m
    out = torch.empty([2, *shape], dtype=x.dtype, device=x.device)
    if out.numel():
        _kernels.launch(
            "K3", "ptwt_analysis_axis", x.device, x.dtype,
            x, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            outer, n, period, m, inner, pad, int(circular),
        )
    return out


def _analysis_transpose_kernel(
    ct: torch.Tensor, ax: int, n: int, lo, hi, period: int, pad: int, circular: bool
) -> torch.Tensor:
    """Launch K3T: the ``[2, ..., m, ...]`` cotangent of a K3 launch ->
    the cotangent of its ``[..., n, ...]`` input."""
    _kernels.check_tensor("ct", ct, ct.dtype, ct.device)
    shape = list(ct.shape[1:])
    m = shape[ax]
    shape[ax] = n
    out = torch.empty(shape, dtype=ct.dtype, device=ct.device)
    if not out.numel():
        return out
    if not m:  # K3 read nothing (a signal shorter than the filter)
        return out.zero_()
    outer, inner = _outer_inner(shape, ax)
    _kernels.launch(
        "K3T", "ptwt_analysis_axis_t", ct.device, ct.dtype,
        ct, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
        outer, n, period, m, inner, pad, int(circular),
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
) -> torch.Tensor:
    """Launch K4 on up to two (lo, hi) pairs -> ``[G, ..., out_len, ...]``."""
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
    if out.numel():
        pair1 = (los[-1], his[-1])
        _kernels.launch(
            "K4", "ptwt_synthesis_axis", ref.device, ref.dtype,
            los[0], his[0], pair1[0], pair1[1], len(los), out,
            _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            outer, m, out_len, inner, off, int(circular),
        )
    return out


def _synthesis_transpose_kernel(
    ct: torch.Tensor, ax: int, m: int, lo, hi, off: int, circular: bool
) -> torch.Tensor:
    """Launch K4T: the ``[G, ..., out_len, ...]`` cotangent of a K4 launch
    -> ``[G, 2, ..., m, ...]``, each pair's (lo, hi) cotangents."""
    _kernels.check_tensor("ct", ct, ct.dtype, ct.device)
    groups = ct.shape[0]
    shape = list(ct.shape[1:])
    out_len = shape[ax]
    shape[ax] = m
    out = torch.empty([groups, 2, *shape], dtype=ct.dtype, device=ct.device)
    if not out.numel():
        return out
    if not out_len:  # K4 wrote nothing
        return out.zero_()
    outer, inner = _outer_inner(shape, ax)
    _kernels.launch(
        "K4T", "ptwt_synthesis_axis_t", ct.device, ct.dtype,
        ct, groups, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
        outer, m, out_len, inner, off, int(circular),
    )
    return out


class _AnalysisAxis(torch.autograd.Function):
    """K3 forward, K3T backward.  Only the geometry is saved: the map is
    linear."""

    @staticmethod
    def forward(ctx, x, ax, lo, hi, m, period, pad, circular):
        ctx.plan = (ax, x.shape[ax], lo, hi, period, pad, circular)
        return _analysis_kernel(x, ax, lo, hi, m, period, pad, circular)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grad = _analysis_transpose_kernel(ct.contiguous(), *ctx.plan)
        return (grad,) + (None,) * 7


class _SynthesisAxis(torch.autograd.Function):
    """K4 forward on ``G`` (lo, hi) pairs, K4T backward."""

    @staticmethod
    def forward(ctx, ax, lo, hi, out_len, off, circular, *bands):
        groups = len(bands) // 2
        ctx.plan = (ax, bands[0].shape[ax], lo, hi, off, circular)
        return _synthesis_kernel(
            bands[:groups], bands[groups:], ax, lo, hi, out_len, off, circular
        )

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        grads = _synthesis_transpose_kernel(ct.contiguous(), *ctx.plan)
        return (None,) * 6 + tuple(grads[:, 0]) + tuple(grads[:, 1])


def pallas_dwt_axis(
    x: torch.Tensor, axis: int, dec_lo, dec_hi, mode: str
) -> torch.Tensor:
    """One analysis level along ``axis``, packed as ``[2, ...]`` (lo, hi).

    ``dec_lo``/``dec_hi`` are flipped (correlation order), as
    ``get_filter_arrays(..., flip=True)`` returns them.  A CPU tensor runs
    :func:`dwt_axis_plain`; a CUDA tensor runs K3.
    """
    if _on_cpu(x):
        return torch.stack(dwt_axis_plain(x, axis, dec_lo, dec_hi, mode))
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    filt_len = len(lo)
    ax = axis % x.ndim
    x = x.contiguous()
    n = x.shape[ax]
    if mode == "periodization":
        # odd axes repeat their last sample (pywt's edge pad to even)
        period = n + n % 2
        return _AnalysisAxis.apply(
            x, ax, lo, hi, period // 2, period, filt_len // 2 - 1, True
        )
    if mode == "periodic":
        # pywt's periodic extension is x[p mod n] for every length: the
        # band's wrap entries come out of the same modulo read
        pad = _std_pad(filt_len)
        m = (n + 2 * pad + n % 2 - filt_len) // 2 + 1
        return _AnalysisAxis.apply(x, ax, lo, hi, m, n, pad, True)
    ext = x if mode == "valid" else fwt_pad(x, filt_len, mode=mode, axes=(ax,))
    n_ext = ext.shape[ax]
    m = max((n_ext - filt_len) // 2 + 1, 0)
    return _AnalysisAxis.apply(ext.contiguous(), ax, lo, hi, m, n_ext, 0, False)


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
    lo = _kernels.static_taps(rec_lo)
    hi = _kernels.static_taps(rec_hi)
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
        ax, lo, hi, max(out_len, 0), off, mode == "periodization", *los, *his
    )
