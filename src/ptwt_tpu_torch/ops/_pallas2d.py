"""One circular 2d filter-bank level over both axes: kernels K1/K2.

Counterpart of :mod:`ptwt_tpu.ops._pallas2d` (module and public names
kept).  One launch reads the image once and writes the four subbands
once (``csrc/dwt2.cu``):

* **K1** (``_dwt2_kernel``) — analysis for ``periodization`` (any shape;
  odd axes repeat their last sample) and even-shaped ``periodic``.  The
  JAX package computes the snug ``h/2 x w/2`` circular band and appends a
  wrap copy of its first ``m - n/2`` rows and columns for ``periodic``;
  K1 reads modulo the period, so it writes the whole ``m_h x m_w`` band,
  wrap entries included, with no copy.
* **K2** (``_idwt2_kernel``) — synthesis of the standard crop: circular
  for ``periodization``; for ``periodic`` the JAX package folds the bands,
  runs the circular synthesis and overwrites the outer ``(2L-3)//2`` rows
  and columns from literal-operator strips.  K2 computes the cropped
  transposed convolution directly (the crop folded into its index range),
  which is exact for any coefficients, so neither the fold nor the strips
  are needed.

Gradients: K1 and K2 are each other's VJP with the same taps and pad, as
in the JAX package's ``_level_calls``, each launch a custom op
(``dwt2_level``, ``idwt2_level`` in ``torch.ops.ptwt_tpu_torch``,
:mod:`._library`).  K1's VJP is K2's circular synthesis
folding the band rows past half the period (the wrap entries of
``periodic``) and the clamped last sample of odd ``periodization`` axes;
K2's VJP is K1's read, zero-bounded for the cropped ``periodic``
synthesis.  Data gradients run on the card, to any order (each VJP's
VJP is its twin again); a filter tensor that requires grad raises there.

The tensor-core variant: with the opt-in ``PTWT_TPU_MXU2D=1``, a float32
level whose full-resolution image passes K9's gate
(:func:`._mxu2d.mxu2_level_ok`: ``h % 128 == 0``, ``w % 256 == 0``, at
most 64 taps) launches K9a in place of K1 and K9b in place of K2, with
the same arguments (:mod:`._mxu2d`, ``csrc/mxu2d.cu``), as the JAX
package's ``_dwt2_call``/``_idwt2_call`` choose its K9.  The VJPs follow
the same decision on the same image, so K9a's VJP is a K9b launch and
K9b's a K9a launch, as in ``_level_calls``.

Each kernel has a plain torch version here (:func:`dwt2_level_plain`,
:func:`idwt2_level_plain`, and for the VJPs :func:`dwt2_level_vjp_plain`,
:func:`idwt2_level_vjp_plain`): two per-axis passes of the plain versions
in :mod:`._pallas2`, and autograd through them.  The wrappers take them
for CPU tensors only; there, a level that K9 would take on the card runs
K9's plain versions (the GEMM form, :mod:`._mxu2d`) when its filters are
constants.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _kernels
from ._library import NAMESPACE, autograd, call, flatten_batch, flatten_list, split_batch
from ._mxu2d import mxu2_dwt_call, mxu2_dwt_plain, mxu2_idwt_call, mxu2_idwt_plain, mxu2_level_ok
from ._pallas2 import _on_cpu, _std_pad, dwt_axis_plain, idwt_axis_plain

__all__ = [
    "dwt2_level_plain",
    "dwt2_level_vjp_plain",
    "idwt2_level_plain",
    "idwt2_level_vjp_plain",
    "fused2_analysis_applicable",
    "fused2_synthesis_applicable",
    "fused2_dwt_level",
    "fused2_idwt_level",
]


def _plan_pad(filt_len: int, mode: str) -> int:
    return filt_len // 2 - 1 if mode == "periodization" else _std_pad(filt_len)


def _reach_ok(h: int, w: int, filt_len: int) -> bool:
    """The half-size axes must cover the tap reach (the JAX package's
    geometry gate without its TPU layout limits)."""
    reach = _std_pad(filt_len) // 2 + 2
    return h // 2 > reach and w // 2 > reach


def fused2_analysis_applicable(h: int, w: int, filt_len: int, mode: str) -> bool:
    """Run this 2d analysis level through K1?  Not ``periodization`` with
    an odd-length bank, whose bands are not half the period (K3/K4 run
    it)."""
    if mode == "periodic":
        if h % 2 or w % 2:
            return False
    elif mode != "periodization" or filt_len % 2:
        return False
    return _reach_ok(h, w, filt_len)


def _synthesis_geometry(
    m_h: int, m_w: int, filt_len: int, mode: str
) -> tuple[int, int]:
    """Output shape of the standard-crop synthesis of ``[m_h, m_w]`` bands."""
    if mode == "periodization":
        return 2 * m_h, 2 * m_w
    p = _std_pad(filt_len)
    return 2 * (m_h - 1) + filt_len - 2 * p, 2 * (m_w - 1) + filt_len - 2 * p


def fused2_synthesis_applicable(
    m_h: int, m_w: int, filt_len: int, mode: str, pads: Sequence[tuple[int, int]]
) -> bool:
    """Run this 2d synthesis level through K2?

    ``pads`` are the per-axis ``(padl, padr)`` crops; K2 takes the
    standard ones only (periodization: none; periodic: the symmetric
    ``(2L-3)//2`` crop of an even-shaped original).
    """
    if mode == "periodization":
        if filt_len % 2:
            return False
        std = (0, 0)
    elif mode == "periodic":
        std = (_std_pad(filt_len),) * 2
    else:
        return False
    if any(tuple(pp) != std for pp in pads):
        return False
    h, w = _synthesis_geometry(m_h, m_w, filt_len, mode)
    if h <= 0 or w <= 0 or h % 2 or w % 2:
        return False
    return _reach_ok(h, w, filt_len)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def dwt2_level_plain(
    x: torch.Tensor, dec_lo, dec_hi, mode: str
) -> tuple[torch.Tensor, ...]:
    """One 2d analysis level in plain torch ops: ``(ll, lh, hl, hh)``."""
    lo, hi = dwt_axis_plain(x, -2, dec_lo, dec_hi, mode)
    ll, hl = dwt_axis_plain(lo, -1, dec_lo, dec_hi, mode)
    lh, hh = dwt_axis_plain(hi, -1, dec_lo, dec_hi, mode)
    return ll, lh, hl, hh


def idwt2_level_plain(
    subbands: Sequence[torch.Tensor],
    rec_lo,
    rec_hi,
    mode: str,
    pads: Sequence[tuple[int, int]],
) -> torch.Tensor:
    """One 2d synthesis level in plain torch ops from ``(ll, lh, hl, hh)``."""
    ll, lh, hl, hh = subbands
    lo = idwt_axis_plain(ll, hl, -1, rec_lo, rec_hi, *pads[1], mode)
    hi = idwt_axis_plain(lh, hh, -1, rec_lo, rec_hi, *pads[1], mode)
    return idwt_axis_plain(lo, hi, -2, rec_lo, rec_hi, *pads[0], mode)


def dwt2_level_vjp_plain(
    x: torch.Tensor, dec_lo, dec_hi, mode: str, cts: Sequence[torch.Tensor]
) -> torch.Tensor:
    """VJP of :func:`dwt2_level_plain` at ``x`` for the four subband
    cotangents: the plain version of K1's VJP."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        bands = dwt2_level_plain(x, dec_lo, dec_hi, mode)
        (grad,) = torch.autograd.grad(bands, x, tuple(cts))
    return grad


def idwt2_level_vjp_plain(
    subbands: Sequence[torch.Tensor],
    rec_lo,
    rec_hi,
    mode: str,
    pads: Sequence[tuple[int, int]],
    ct: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """VJP of :func:`idwt2_level_plain` for the output cotangent ``ct``:
    the four subband cotangents, the plain version of K2's VJP."""
    with torch.enable_grad():
        bands = [b.detach().requires_grad_() for b in subbands]
        out = idwt2_level_plain(bands, rec_lo, rec_hi, mode, pads)
        return torch.autograd.grad(out, bands, ct)


def _mxu2_plain(h: int, w: int, dtype, *filters) -> bool:
    """On the CPU: run K9's plain version for this level?  Where K9 would
    take it on the card and the filters are constants (the GEMM form's
    band matrices carry no filter gradient)."""
    if any(_kernels.grad_tracked(f) for f in filters):
        return False
    return mxu2_level_ok(h, w, len(filters[0]), dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _dwt2_kernel(
    x: torch.Tensor,
    lo,
    hi,
    period_h: int,
    period_w: int,
    m_h: int,
    m_w: int,
    pad: int,
    circular: bool = True,
) -> torch.Tensor:
    """Launch K1 (K9a where K9's gate takes the image) on ``[B, h, w]`` ->
    ``[4, B, m_h, m_w]``; ``circular=False`` reads zero outside the image."""
    b, h, w = x.shape
    if mxu2_level_ok(h, w, len(lo), x.dtype):
        return mxu2_dwt_call(x, lo, hi, period_h, period_w, m_h, m_w, pad, circular)
    _kernels.check_tensor("x", x, x.dtype, x.device)
    out = torch.empty((4, b, m_h, m_w), dtype=x.dtype, device=x.device)
    if out.numel():
        _kernels.launch(
            "K1", "ptwt_dwt2", x.device, x.dtype,
            x, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            b, h, w, period_h, period_w, m_h, m_w, pad, int(circular),
        )
    return out


def _idwt2_kernel(
    bands: Sequence[torch.Tensor],
    lo,
    hi,
    out_h: int,
    out_w: int,
    off: int,
    circular: bool,
    fold: tuple[int, int, int, int] | None = None,
) -> torch.Tensor:
    """Launch K2 (K9b where K9's gate takes the ``out_h x out_w`` image) on
    four ``[B, m_h, m_w]`` bands -> ``[B, out_h, out_w]``.

    ``fold = (half_h, half_w, per_h, per_w)``: circular reads modulo
    ``half`` that also collect the band rows ``+ half, + 2 half, ...``, and
    output positions ``[out, per)`` added to the last row and column (the
    adjoint of K1's reads); None is the plain synthesis.
    """
    ref = bands[0]
    if mxu2_level_ok(out_h, out_w, len(lo), ref.dtype):
        return mxu2_idwt_call(bands, lo, hi, out_h, out_w, off, circular, fold)
    for name, t in zip(("ll", "lh", "hl", "hh"), bands):
        _kernels.check_tensor(name, t, ref.dtype, ref.device)
        if t.shape != ref.shape:
            raise ValueError(f"all subbands must share one shape, got {t.shape} and {ref.shape}")
    b, m_h, m_w = ref.shape
    if fold is None:
        fold = (m_h, m_w, out_h, out_w)
    out = torch.empty((b, out_h, out_w), dtype=ref.dtype, device=ref.device)
    if out.numel():
        _kernels.launch(
            "K2", "ptwt_idwt2", ref.device, ref.dtype,
            *bands, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            b, m_h, m_w, out_h, out_w, off, off, int(circular), *fold,
        )
    return out


# K1 (or K9a): one circular 2d analysis level (also K2's VJP, zero-bounded)


@torch.library.custom_op(f"{NAMESPACE}::dwt2_level", mutates_args=())
def dwt2_level(
    x: torch.Tensor,
    lo: list[float],
    hi: list[float],
    per_h: int,
    per_w: int,
    m_h: int,
    m_w: int,
    pad: int,
    circular: bool,
) -> torch.Tensor:
    """K1 (K9a where its gate takes the image) on ``[B, h, w]`` -> ``[4, B,
    m_h, m_w]`` (:func:`_dwt2_kernel`)."""
    return _dwt2_kernel(x, lo, hi, per_h, per_w, m_h, m_w, pad, circular)


@dwt2_level.register_fake
def _(x, lo, hi, per_h, per_w, m_h, m_w, pad, circular):
    return x.new_empty((4, x.shape[0], m_h, m_w))


def _dwt2_setup(ctx, inputs, output):
    x, lo, hi, per_h, per_w, m_h, m_w, pad, circular = inputs
    _, h, w = x.shape
    fold = (per_h // 2, per_w // 2, per_h, per_w) if circular else (m_h, m_w, h, w)
    ctx.plan = (lo, hi, h, w, pad, circular, fold)


def _dwt2_backward(ctx, ct):
    """K1's VJP: K2 (or K9b) with the same taps, ``off = pad``, folding
    modulo half the period (the zero-bounded instance's: the plain crop)."""
    lo, hi, h, w, pad, circular, fold = ctx.plan
    grad = call(idwt2_level, list(ct.contiguous().unbind(0)), lo, hi, h, w, pad, circular, list(fold))
    return (grad,) + (None,) * 8


@dwt2_level.register_vmap
def _(info, in_dims, x, lo, hi, per_h, per_w, m_h, m_w, pad, circular):
    size = info.batch_size
    out = dwt2_level(flatten_batch(x, in_dims[0], size), lo, hi, per_h, per_w, m_h, m_w, pad, circular)
    return split_batch(out, size, 1), 1


# K2 (or K9b): one circular 2d synthesis level of the standard crop (also
# K1's VJP, the fold instance)


@torch.library.custom_op(f"{NAMESPACE}::idwt2_level", mutates_args=())
def idwt2_level(
    bands: list[torch.Tensor],
    lo: list[float],
    hi: list[float],
    out_h: int,
    out_w: int,
    off: int,
    circular: bool,
    fold: list[int],
) -> torch.Tensor:
    """K2 (K9b where its gate takes the image) on four ``[B, m_h, m_w]``
    bands -> ``[B, out_h, out_w]`` (:func:`_idwt2_kernel`; ``fold`` as its,
    ``(m_h, m_w, out_h, out_w)`` for the plain synthesis)."""
    return _idwt2_kernel(bands, lo, hi, out_h, out_w, off, circular, tuple(fold))


@idwt2_level.register_fake
def _(bands, lo, hi, out_h, out_w, off, circular, fold):
    return bands[0].new_empty((bands[0].shape[0], out_h, out_w))


def _idwt2_setup(ctx, inputs, output):
    bands, lo, hi, out_h, out_w, off, circular, fold = inputs
    ctx.plan = (lo, hi, *bands[0].shape[-2:], off, circular, fold)


def _idwt2_backward(ctx, ct):
    """K2's VJP: K1 (or K9a) with the same taps and ``pad = off``, reading
    modulo the fold's period (the output for the plain synthesis) or zero
    outside the output."""
    lo, hi, m_h, m_w, off, circular, fold = ctx.plan
    grads = call(dwt2_level, ct.contiguous(), lo, hi, fold[2], fold[3], m_h, m_w, off, circular)
    return (list(grads.unbind(0)),) + (None,) * 7


@idwt2_level.register_vmap
def _(info, in_dims, bands, lo, hi, out_h, out_w, off, circular, fold):
    size = info.batch_size
    out = idwt2_level(flatten_list(bands, in_dims[0], size), lo, hi, out_h, out_w, off, circular, fold)
    return split_batch(out, size), 0


autograd(dwt2_level, _dwt2_setup, _dwt2_backward)
autograd(idwt2_level, _idwt2_setup, _idwt2_backward)


def fused2_dwt_level(
    x: torch.Tensor, dec_lo, dec_hi, mode: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 2d analysis level; returns ``(ll, lh, hl, hh)``.

    ``lh`` is hi along the first spatial axis.  ``dec_lo``/``dec_hi`` are
    flipped (correlation order).  Gate with
    :func:`fused2_analysis_applicable`.  A CPU tensor runs
    :func:`dwt2_level_plain` (K9a's plain version where K9 would take the
    level); a CUDA tensor runs K1 or K9a.
    """
    filt_len = len(dec_lo)
    pad = _plan_pad(filt_len, mode)
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    if mode == "periodization":
        per_h, per_w = h + h % 2, w + w % 2
        m_h, m_w = per_h // 2, per_w // 2
    else:
        per_h, per_w = h, w
        m_h = (h + 2 * pad - filt_len) // 2 + 1
        m_w = (w + 2 * pad - filt_len) // 2 + 1
    on_cpu = _on_cpu(x)
    if on_cpu and not _mxu2_plain(h, w, x.dtype, dec_lo, dec_hi):
        return dwt2_level_plain(x, dec_lo, dec_hi, mode)
    lo, hi = _kernels.static_taps(dec_lo), _kernels.static_taps(dec_hi)
    flat = x.reshape(-1, h, w)
    if on_cpu:
        bands = mxu2_dwt_plain(flat, lo, hi, per_h, per_w, m_h, m_w, pad)
    else:
        bands = call(dwt2_level, flat.contiguous(), lo, hi, per_h, per_w, m_h, m_w, pad, True)
    return tuple(band.reshape(*lead, m_h, m_w) for band in bands.unbind(0))


def fused2_idwt_level(
    subbands: Sequence[torch.Tensor], rec_lo, rec_hi, mode: str
) -> torch.Tensor:
    """One 2d synthesis level of the standard crop from ``(ll, lh, hl, hh)``.

    Gate with :func:`fused2_synthesis_applicable`: ``periodization``
    reconstructs ``[2m_h, 2m_w]``, ``periodic`` the even original.  A CPU
    tensor runs :func:`idwt2_level_plain` (K9b's plain version where K9
    would take the level); a CUDA tensor runs K2 or K9b.
    """
    filt_len = len(rec_lo)
    pad = _plan_pad(filt_len, mode)
    lead = subbands[0].shape[:-2]
    m_h, m_w = subbands[0].shape[-2:]
    out_h, out_w = _synthesis_geometry(m_h, m_w, filt_len, mode)
    circular = mode == "periodization"
    on_cpu = _on_cpu(subbands[0])
    if on_cpu and not _mxu2_plain(out_h, out_w, subbands[0].dtype, rec_lo, rec_hi):
        p = 0 if circular else pad
        return idwt2_level_plain(subbands, rec_lo, rec_hi, mode, [(p, p), (p, p)])
    lo, hi = _kernels.static_taps(rec_lo), _kernels.static_taps(rec_hi)
    flat = [b.reshape(-1, m_h, m_w) for b in subbands]
    if on_cpu:
        out = mxu2_idwt_plain(flat, lo, hi, out_h, out_w, pad, circular)
    else:
        flat = [b.contiguous() for b in flat]
        out = call(idwt2_level, flat, lo, hi, out_h, out_w, pad, circular, [m_h, m_w, out_h, out_w])
    return out.reshape(*lead, out_h, out_w)
