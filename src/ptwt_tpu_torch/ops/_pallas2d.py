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

Each kernel has a plain torch version here (:func:`dwt2_level_plain`,
:func:`idwt2_level_plain`): two per-axis passes of the plain versions in
:mod:`._pallas2`.  The wrappers take it for CPU tensors only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _kernels
from ._pallas2 import _on_cpu, _std_pad, dwt_axis_plain, idwt_axis_plain

__all__ = [
    "dwt2_level_plain",
    "idwt2_level_plain",
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
    """Run this 2d analysis level through K1?"""
    if mode == "periodic":
        if h % 2 or w % 2:
            return False
    elif mode != "periodization":
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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _dwt2_kernel(
    x: torch.Tensor, lo, hi, period_h: int, period_w: int, m_h: int, m_w: int, pad: int
) -> torch.Tensor:
    """Launch K1 on ``[B, h, w]`` -> ``[4, B, m_h, m_w]``."""
    _kernels.refuse_grad(x)
    _kernels.check_tensor("x", x, x.dtype, x.device)
    b, h, w = x.shape
    out = torch.empty((4, b, m_h, m_w), dtype=x.dtype, device=x.device)
    if out.numel():
        _kernels.launch(
            "K1", "ptwt_dwt2", x.device, x.dtype,
            x, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            b, h, w, period_h, period_w, m_h, m_w, pad,
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
) -> torch.Tensor:
    """Launch K2 on four ``[B, m_h, m_w]`` bands -> ``[B, out_h, out_w]``."""
    _kernels.refuse_grad(*bands)
    ref = bands[0]
    for name, t in zip(("ll", "lh", "hl", "hh"), bands):
        _kernels.check_tensor(name, t, ref.dtype, ref.device)
        if t.shape != ref.shape:
            raise ValueError(f"all subbands must share one shape, got {t.shape} and {ref.shape}")
    b, m_h, m_w = ref.shape
    out = torch.empty((b, out_h, out_w), dtype=ref.dtype, device=ref.device)
    if out.numel():
        _kernels.launch(
            "K2", "ptwt_idwt2", ref.device, ref.dtype,
            *bands, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            b, m_h, m_w, out_h, out_w, off, off, int(circular),
        )
    return out


def fused2_dwt_level(
    x: torch.Tensor, dec_lo, dec_hi, mode: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 2d analysis level; returns ``(ll, lh, hl, hh)``.

    ``lh`` is hi along the first spatial axis.  ``dec_lo``/``dec_hi`` are
    flipped (correlation order).  Gate with
    :func:`fused2_analysis_applicable`.  A CPU tensor runs
    :func:`dwt2_level_plain`; a CUDA tensor runs K1.
    """
    if _on_cpu(x):
        return dwt2_level_plain(x, dec_lo, dec_hi, mode)
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    filt_len = len(lo)
    pad = _plan_pad(filt_len, mode)
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    flat = x.reshape(-1, h, w).contiguous()
    if mode == "periodization":
        per_h, per_w = h + h % 2, w + w % 2
        m_h, m_w = per_h // 2, per_w // 2
    else:
        per_h, per_w = h, w
        m_h = (h + 2 * pad - filt_len) // 2 + 1
        m_w = (w + 2 * pad - filt_len) // 2 + 1
    bands = _dwt2_kernel(flat, lo, hi, per_h, per_w, m_h, m_w, pad)
    return tuple(band.reshape(*lead, m_h, m_w) for band in bands)


def fused2_idwt_level(
    subbands: Sequence[torch.Tensor], rec_lo, rec_hi, mode: str
) -> torch.Tensor:
    """One 2d synthesis level of the standard crop from ``(ll, lh, hl, hh)``.

    Gate with :func:`fused2_synthesis_applicable`: ``periodization``
    reconstructs ``[2m_h, 2m_w]``, ``periodic`` the even original.  A CPU
    tensor runs :func:`idwt2_level_plain`; a CUDA tensor runs K2.
    """
    filt_len = len(rec_lo)
    if _on_cpu(subbands[0]):
        p = 0 if mode == "periodization" else _std_pad(filt_len)
        return idwt2_level_plain(subbands, rec_lo, rec_hi, mode, [(p, p), (p, p)])
    lo = _kernels.static_taps(rec_lo)
    hi = _kernels.static_taps(rec_hi)
    lead = subbands[0].shape[:-2]
    m_h, m_w = subbands[0].shape[-2:]
    flat = [b.reshape(-1, m_h, m_w).contiguous() for b in subbands]
    out_h, out_w = _synthesis_geometry(m_h, m_w, filt_len, mode)
    out = _idwt2_kernel(
        flat, lo, hi, out_h, out_w, _plan_pad(filt_len, mode), mode == "periodization"
    )
    return out.reshape(*lead, out_h, out_w)
