"""The whole 1d periodization pyramid per row: kernels K6a/K6b.

Counterpart of the 1d half of :mod:`ptwt_tpu.ops._pallas`, whose Pallas
kernels keep a batch row's entire level pyramid in VMEM: K6a
(``_make_wavedec_kernel_ph``) carries only the ``lo`` chain between
levels and writes each detail band once, K6b (``_make_waverec_kernel``)
runs the inverse.  A row of ``2**19`` float32 samples is 2 MB, beyond the
227 KB of shared memory a block of the H100 holds, so here the pyramid is
cut into runs of at most four levels, each one launch of the tile-fused
pyramid kernels of ``csrc/fwt1d.cu`` with circular reads:

* **K6a** -- ``analysis_pyramid_kernel<T, true>``: a block owns a tile of
  the run's deepest band and reads its input cone modulo the band length.
  On an exactly halving chain every level is periodic in its length, so
  the whole cone is exact and no edge pass is needed; only the run's
  ``lo`` goes back to device memory.
* **K6b** -- ``synthesis_pyramid_kernel<T, true>``: a block owns a tile of
  the run's finest output and reads its bands modulo their length.

Every launch counts as K6a or K6b.  The gate keeps the JAX package's
semantics (``periodization`` on an exactly halving chain, every level's
input even) and drops its Mosaic limits (float32 only, power-of-two
lengths up to ``2**19``, the ``[8, n/8]`` tile of the deepest level).  The
2d pyramid (K5) is not part of this module yet.

The plain versions run the levels one by one through
:func:`~._pallas2.dwt_axis_plain` / :func:`~._pallas2.idwt_axis_plain`;
the wrappers take them for CPU tensors only.  A CUDA tensor that requires
grad raises ``NotImplementedError`` (the 1d training slice brings K6a and
K6b as each other's VJP).
"""

from __future__ import annotations

import torch

from . import _kernels
from ._pallas1d_multi import (
    MAX_FUSED_DEPTH,
    MAX_TAPS,
    analysis_pyramid,
    check_no_grad,
    synthesis_pyramid,
)
from ._pallas2 import _on_cpu, dwt_axis_plain, idwt_axis_plain

__all__ = [
    "fused_wavedec1d_per",
    "fused_wavedec_applicable",
    "fused_waverec1d_per",
    "wavedec1d_per_plain",
    "waverec1d_per_plain",
]


def fused_wavedec_applicable(n: int, filt_len: int, level: int) -> bool:
    """Static gate: ``level`` periodization levels halve ``n`` exactly,
    and the kernels hold the filter."""
    return level >= 1 and n > 0 and n % (1 << level) == 0 and 2 <= filt_len <= MAX_TAPS


def _runs(level: int) -> list[int]:
    """Depths of the launches of a ``level``-level pyramid, fine to coarse."""
    return [MAX_FUSED_DEPTH] * (level // MAX_FUSED_DEPTH) + (
        [level % MAX_FUSED_DEPTH] if level % MAX_FUSED_DEPTH else []
    )


def wavedec1d_per_plain(data: torch.Tensor, dec_lo, dec_hi, level: int) -> list[torch.Tensor]:
    """Level-by-level periodization analysis: ``[cA_level, cD_level, ...,
    cD_1]``."""
    his = []
    cur = data
    for _ in range(level):
        cur, h = dwt_axis_plain(cur, -1, dec_lo, dec_hi, "periodization")
        his.append(h)
    return [cur, *his[::-1]]


def waverec1d_per_plain(coeffs, rec_lo, rec_hi) -> torch.Tensor:
    """Level-by-level periodization synthesis of ``[cA, cD_L, ..., cD_1]``."""
    cur = coeffs[0]
    for hi in coeffs[1:]:
        cur = idwt_axis_plain(cur, hi, -1, rec_lo, rec_hi, 0, 0, "periodization")
    return cur


def fused_wavedec1d_per(data: torch.Tensor, dec_lo, dec_hi, level: int) -> list[torch.Tensor]:
    """Multi-level periodization analysis of ``[batch, n]``.

    Returns ``[cA_level, cD_level, ..., cD_1]``, the values and order of
    the level-by-level periodization ``wavedec``.  ``dec_lo``/``dec_hi``
    are flipped.  A CPU tensor runs :func:`wavedec1d_per_plain`; a CUDA
    tensor runs K6a, one launch per run of at most four levels.
    """
    if _on_cpu(data):
        return wavedec1d_per_plain(data, dec_lo, dec_hi, level)
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    check_no_grad(data)
    cur = data.contiguous()
    his: list[torch.Tensor] = []
    for depth in _runs(level):
        cur, run = analysis_pyramid("K6a", cur, lo, hi, depth, "periodization")
        his.extend(run)
    return [cur, *his[::-1]]


def fused_waverec1d_per(coeffs, rec_lo, rec_hi) -> torch.Tensor:
    """Multi-level periodization synthesis (the inverse of
    :func:`fused_wavedec1d_per`) of ``[cA, cD_L, ..., cD_1]``, each
    ``[batch, m]``.  A CPU tensor runs :func:`waverec1d_per_plain`; a CUDA
    tensor runs K6b, one launch per run of at most four steps."""
    if _on_cpu(coeffs[0]):
        return waverec1d_per_plain(coeffs, rec_lo, rec_hi)
    lo = _kernels.static_taps(rec_lo)
    hi = _kernels.static_taps(rec_hi)
    check_no_grad(*coeffs)
    filt_len = len(lo)
    cur = coeffs[0].contiguous()
    done = 0
    for depth in _runs(len(coeffs) - 1)[::-1]:  # coarse to fine
        his = [c.contiguous() for c in coeffs[1 + done : 1 + done + depth]]
        out_len = 2 * his[-1].shape[-1]
        cur = synthesis_pyramid(
            "K6b", [cur, *his], lo, hi, [filt_len // 2 - 1] * depth, out_len, True
        )
        done += depth
    return cur
