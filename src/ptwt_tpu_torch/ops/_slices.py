"""Shift-and-scale DWT along the last axis (the plain torch level ops).

Counterpart of :mod:`ptwt_tpu.ops._slices`: one FWT level is a sum of
``filt_len`` scaled unit-stride slices of the even/odd polyphase
components.  These are the plain versions every hand-written kernel is
held against, and the CPU path of the port; with filters given as tensors
they are autograd-transparent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["analysis_slices_lastaxis", "synthesis_slices_lastaxis"]


def _taps(filt, ref: torch.Tensor):
    """Filter taps usable as scalar multipliers against ``ref``.

    A tensor filter stays a tensor (so gradients reach it); a static filter
    becomes python floats.
    """
    if isinstance(filt, torch.Tensor):
        return filt.to(device=ref.device, dtype=ref.dtype)
    return [float(v) for v in filt]


def analysis_slices_lastaxis(
    data: torch.Tensor, dec_lo, dec_hi
) -> tuple[torch.Tensor, torch.Tensor]:
    """One analysis level along the last axis of already-padded ``data``.

    ``out[..., i] = sum_k f[k] * data[..., 2*i + k]`` with the pre-flipped
    decomposition filters.
    """
    lo_f = _taps(dec_lo, data)
    hi_f = _taps(dec_hi, data)
    filt_len = len(lo_f)
    n = data.shape[-1]
    m = (n - filt_len) // 2 + 1
    half = m + filt_len // 2
    phases = F.pad(data, (0, 2 * half - n)).reshape(*data.shape[:-1], half, 2)
    even, odd = phases[..., 0], phases[..., 1]
    lo = hi = None
    for k in range(filt_len):
        src = even if k % 2 == 0 else odd
        sl = src[..., k // 2 : k // 2 + m]
        lo = lo_f[k] * sl if lo is None else lo + lo_f[k] * sl
        hi = hi_f[k] * sl if hi is None else hi + hi_f[k] * sl
    return lo, hi


def synthesis_slices_lastaxis(
    lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi
) -> torch.Tensor:
    """One synthesis level along the last axis (uncropped).

    The stride-2 transposed convolution
    ``out[i] = sum_j lo[j] rec_lo[i-2j] + hi[j] rec_hi[i-2j]`` of length
    ``2*(m-1) + filt_len``, computed per output phase as shifted slices.
    """
    lo_f = _taps(rec_lo, lo)
    hi_f = _taps(rec_hi, lo)
    filt_len = len(lo_f)
    m = lo.shape[-1]
    full = 2 * (m - 1) + filt_len
    half = (full + 1) // 2  # outputs per phase (phase 0 has ceil)
    kmax = (filt_len + 1) // 2
    lo_p = F.pad(lo, (kmax - 1, kmax - 1))
    hi_p = F.pad(hi, (kmax - 1, kmax - 1))
    phases = []
    for p in (0, 1):
        n_p = half if p == 0 else full - half
        acc = lo.new_zeros(*lo.shape[:-1], n_p)
        # out[2t+p] = sum_q rec[2q+p] * c[t-q]
        for q in range((filt_len - p + 1) // 2):
            start = kmax - 1 - q
            acc = (
                acc
                + lo_f[2 * q + p] * lo_p[..., start : start + n_p]
                + hi_f[2 * q + p] * hi_p[..., start : start + n_p]
            )
        phases.append(acc)
    even, odd = phases
    if even.shape[-1] != odd.shape[-1]:
        odd = F.pad(odd, (0, 1))
    # explicit length: an empty batch leaves no -1 to infer
    out = torch.stack([even, odd], dim=-1).reshape(*lo.shape[:-1], 2 * even.shape[-1])
    return out[..., :full]
