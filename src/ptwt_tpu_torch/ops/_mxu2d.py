"""Tensor-core band-GEMM kernels for one circular 2d level: K9a/K9b.

Counterpart of :mod:`ptwt_tpu.ops._mxu2d` (public names kept).  The same
level as K1/K2 (:mod:`._pallas2d`), computed as banded-window matrix
products: along W, ``x_ext[:, 256j : 256j+384] @ FW`` with ``FW[2c+k, c]
= lo[k]`` and ``FW[2c+k, 128+c] = hi[k]``; along H, ``FH @
y[128i : 128i+KH, :]``; the synthesis with ``SH_lo/SH_hi`` and
``SW_lo/SW_hi`` built from the parity-matched taps of ``_syn_taps``.

* **K9a** (``csrc/mxu2d.cu``, replaces ``ptwt_tpu/ops/_mxu2d.py``
  ``_dwt_kernel``) takes the arguments of a K1 launch and gives its
  output, every mode included: the image read modulo the period, or zero
  beyond it (K9b's VJP).
* **K9b** (replaces ``_idwt_kernel``) takes the arguments of a K2 launch:
  the cropped ``periodic`` synthesis with the crop folded into the index
  range, the circular ``periodization`` synthesis, and the fold of the
  band rows past half the period (K9a's VJP).

A persistent block walks tiles of the output with a ring of staged
windows (:func:`analysis_plan`, :func:`synthesis_plan`: the ints the
kernels take and check), each window staged in shared memory with the
mode's extension (wrap, zeros, or band rows folded modulo half the
period): that choice is made at staging, not in the products.  The
products run on the tensor cores as ``mma.sync.m16n8k8`` with TF32
operands and float32 accumulators.  One TF32 pass keeps 10 mantissa bits, about 3 decimal
digits: 5e-4 relative on the headline's level on an H100, 25 times the
port's 2e-5 limit (a debug build, ``-DPTWT_MXU2D_ONE_PASS``); so every
operand is split ``a = a_hi + a_lo`` (``a_hi`` = ``a`` cut to TF32,
``a_lo = a - a_hi``) and each product is ``hi*hi + hi*lo + lo*hi``
(3xTF32), about float32's accuracy.  The band matrices
are never loaded: they are 98% zeros (a 384 x 256 ``FW`` holds 2,048
taps at db4) and would not fit in shared memory, so each thread builds
its operand fragments from the taps and a block multiplies only the
k-blocks inside the band.  On the H100 that leaves the level bound by its
bytes, as K1/K2 are: the image read once and the four bands written once.

Weights: none.  The fragments come from the taps of
:func:`~._kernels.static_taps`, as K1/K2's do.

Gate (:func:`mxu2_level_ok`): the opt-in ``PTWT_TPU_MXU2D=1`` (read at
call time, default off, as in the JAX package), float32 (float64 stays on
K1/K2), at most 64 taps, and a full-resolution image with ``h % 128 ==
0`` and ``w % 256 == 0``; the caller has already applied K1/K2's own gate.
It is the JAX package's analysis gate (``mxu2_analysis_ok``) without its
8 MB image cap, a TPU VMEM budget; the JAX synthesis gate (``m_w % 128``,
``m_h % 64`` on the snug band) is the same condition on the image.  The
same gate on the same image routes the VJP, so a K9a level's VJP is a K9b
launch and the reverse.

The plain versions :func:`mxu2_dwt_plain` / :func:`mxu2_idwt_plain`
compute the same launches in the GEMM form in plain torch (windows
unfolded, multiplied by the band matrices built in float64 and cast at
use).  CPU tensors take them under the same decision; on the card they
are the reference the kernels are held against, and nothing on the main
path calls them.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
import torch

from . import _kernels

__all__ = [
    "mxu2_enabled",
    "mxu2_analysis_ok",
    "mxu2_synthesis_ok",
    "mxu2_level_ok",
    "mxu2_dwt_plain",
    "mxu2_idwt_plain",
    "mxu2_dwt_call",
    "mxu2_idwt_call",
]

#: The longest filter K9 takes (the JAX package's gate).
MAX_TAPS = 64


def mxu2_enabled() -> bool:
    """Opt-in, read at call time: ``PTWT_TPU_MXU2D=1``."""
    return os.environ.get("PTWT_TPU_MXU2D") == "1"


def mxu2_analysis_ok(h: int, w: int, filt_len: int) -> bool:
    """Gate of one K9 level on its full-resolution ``h x w`` image."""
    if not mxu2_enabled() or filt_len > MAX_TAPS:
        return False
    return h % 128 == 0 and w % 256 == 0 and h >= 128 and w >= 256


def mxu2_synthesis_ok(m_h: int, m_w: int, filt_len: int) -> bool:
    """The gate on the snug ``m_h x m_w`` band of a synthesis level."""
    return mxu2_analysis_ok(2 * m_h, 2 * m_w, filt_len)


def mxu2_level_ok(h: int, w: int, filt_len: int, dtype: torch.dtype) -> bool:
    """Run this level (either direction, image ``h x w``) through K9?"""
    return dtype == torch.float32 and mxu2_analysis_ok(h, w, filt_len)


# ---------------------------------------------------------------------------
# the kernels' tile plans (the ints csrc/mxu2d.cu takes and checks)
# ---------------------------------------------------------------------------

#: Shared memory of one block (bytes): two blocks share an SM of the H100
#: (228 KB, 1 KB of it reserved per block), so that one block's staging
#: and barriers overlap the other's products.
SMEM_LIMIT = 115712
#: Tiles tried in order, the first whose block fits :data:`SMEM_LIMIT` with
#: a ring of three staged windows, then of two: K9a (band rows, band
#: columns); K9b (output rows, output columns), its rows cut to the most
#: whose band window is whole 16-row slabs.
ANALYSIS_TILES = ((32, 32), (16, 32), (8, 16))
SYNTHESIS_TILES = ((64, 64), (32, 64), (32, 32), (8, 16))
#: Bytes of one lane's B operand fragment in the tables: an 8 x 8 B
#: operand, 2 big and 2 small TF32 words.
FRAG_B_BYTES = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _stride(n: int, mod: int, rem: int) -> int:
    """The least stride >= ``n`` that is ``rem`` modulo ``mod`` (shared
    memory rows whose fragment loads hit distinct banks)."""
    return n + (rem - n) % mod


def analysis_smem(plan: tuple) -> int:
    """Shared memory of one K9a block: the two fragment tables, the ring
    of staged input windows and the W pass's output, transposed."""
    tn, kw, kh, sy, xbuf, stages = plan[1], plan[3], plan[4], plan[8], plan[11], plan[12]
    return 64 * FRAG_B_BYTES * (kw + kh) + 4 * (stages * xbuf + 2 * tn * sy)


@functools.lru_cache(maxsize=256)
def analysis_plan(filt_len: int, pad: int, m_h: int, m_w: int) -> tuple:
    """K9a's plan: ``AnaPlan`` of ``csrc/mxu2d.cu``, 13 ints.

    ``tm, tn``: the band positions of a tile; ``off``: the staged window
    starts ``off`` columns left of the tile's first read (``2 j0 - pad``),
    so its 4-column chunks are 16-byte aligned; ``kw``: k-steps of 8 input
    columns per 8 band columns (the W pass), ``kh``: of 8 rows of the W
    pass's output per 8 band rows (the H pass); ``xrows, xcols``: the
    largest staged window (the W pass computes 16-row slabs, so ``xrows``
    is the H pass's reach rounded up to 16); ``sx, sy``: row strides of
    the window and of the transposed W pass output; ``tiles_h, tiles_w``;
    ``xbuf``: the floats of one ring stage; ``stages``: the ring's depth.
    """
    L = filt_len
    off = (-pad) % 4
    kw = _cdiv(off + 14 + L, 8)
    kh = _cdiv(14 + L, 8)
    for stages in (3, 2):
        for tm, tn in ANALYSIS_TILES:
            xrows = _cdiv(2 * tm - 16 + 8 * kh, 16) * 16
            xcols = 2 * tn - 16 + 8 * kw
            sx, sy = _stride(xcols, 8, 4), _stride(xrows, 16, 4)
            plan = (tm, tn, off, kw, kh, xrows, xcols, sx, sy, _cdiv(m_h, tm), _cdiv(m_w, tn),
                    xrows * sx, stages)
            if analysis_smem(plan) <= SMEM_LIMIT:
                return plan
    raise ValueError(f"no K9a tile holds {L} taps")


def synthesis_smem(plan: tuple) -> int:
    """Shared memory of one K9b block: the tables, the ring of staged band
    windows (four bands each) and the W pass's output, transposed."""
    tv, ks, kw, st, bbuf, stages = plan[1], plan[8], plan[9], plan[13], plan[16], plan[17]
    return 64 * FRAG_B_BYTES * (kw + ks) + 4 * (stages * bbuf + 2 * tv * st)


@functools.lru_cache(maxsize=256)
def synthesis_plan(
    filt_len: int, off_h: int, off_w: int, m_h: int, m_w: int, out_h: int, out_w: int
) -> tuple:
    """K9b's plan: ``SynPlan`` of ``csrc/mxu2d.cu``, 18 ints.

    ``tu, tv``: the outputs of a tile; a tile at ``(u0, v0)`` reads band
    rows from ``q0 = u0 / 2 + dq_h`` and columns from ``v0 / 2 + dq_w``,
    and output ``u0 + mu`` takes tap ``e_h + mu - 2 mq`` of band row ``q0
    + mq``; ``o``: the staged window starts ``o`` columns left of that,
    16-byte aligned; ``base``: the first window column of output columns
    ``[0, 8)`` (those of 8 n start ``4 n`` further); ``ks``: k-steps of 8
    band rows per 8 output rows (the H pass), ``kw``: of 8 band columns per
    8 output columns (the W pass, run first); ``brows, bcols``: the largest
    staged window; ``sb, st``: row strides of the window and of the
    transposed W pass output; ``tiles_h, tiles_w``; ``bbuf``: the floats of
    one ring stage; ``stages``: the ring's depth.
    """
    L = filt_len
    dq_h, dq_w = (off_h - L + 1) // 2, (off_w - L + 1) // 2
    e_h, e_w = off_h - 2 * dq_h, off_w - 2 * dq_w
    o = dq_w % 4
    lo = -((L - 1 - e_w) // 2)  # ceil((e_w - L + 1) / 2)
    base = (o + lo) // 4 * 4
    kw = _cdiv(o + (7 + e_w) // 2 + 1 - base, 8)
    ks = (7 + e_h) // 2 // 8 + 1
    for stages in (3, 2):
        for rows, tv in SYNTHESIS_TILES:
            # rows r reach band row r / 2 - 4 + 8 ks: whole 16-row slabs
            tu = max(8, rows - (rows - 8 + 16 * ks) % 32)
            brows = _cdiv(tu // 2 - 4 + 8 * ks, 16) * 16
            bcols = tv // 2 - 4 + base + 8 * kw
            sb, st = _stride(bcols, 8, 4), _stride(brows, 16, 4)
            plan = (tu, tv, dq_h, dq_w, e_h, e_w, o, base, ks, kw, brows, bcols, sb, st,
                    _cdiv(out_h, tu), _cdiv(out_w, tv), 4 * brows * sb, stages)
            if synthesis_smem(plan) <= SMEM_LIMIT:
                return plan
    raise ValueError(f"no K9b tile holds {L} taps")


# ---------------------------------------------------------------------------
# host-built band matrices (float64 construction, cast at use)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _analysis_mats(lo: tuple, hi: tuple):
    """(FW [384, 256], FH [128, KH]) for the blocked analysis passes."""
    L = len(lo)
    fw = np.zeros((384, 256), np.float64)
    for c in range(128):
        for k in range(L):
            fw[2 * c + k, c] = lo[k]
            fw[2 * c + k, 128 + c] = hi[k]
    kh = -(-(126 + L) // 8) * 8
    fh = np.zeros((128, kh), np.float64)
    for c in range(64):
        for k in range(L):
            fh[c, 2 * c + k] = lo[k]
            fh[64 + c, 2 * c + k] = hi[k]
    return fw, fh


def _syn_taps(L: int, pad: int):
    """Parity-matched (ph, k, s) with ``s = (ph + pad - k) / 2``."""
    taps = []
    for ph in (0, 1):
        for k in range(L):
            if (ph + pad - k) % 2 == 0:
                taps.append((ph, k, (ph + pad - k) // 2))
    return taps


@functools.lru_cache(maxsize=256)
def _synthesis_mats(lo: tuple, hi: tuple, pad: int):
    """(SH_lo/SH_hi [128, KHs], SW_lo/SW_hi [256, 256], s_min, ext, KHs)."""
    L = len(lo)
    taps = _syn_taps(L, pad)
    s_min = min(s for _, _, s in taps)
    s_max = max(s for _, _, s in taps)
    ext = s_max - s_min

    max_dh = (127 + pad) // 2 - s_min
    khs = -(-(max_dh + 1) // 8) * 8
    sh = np.zeros((2, 128, khs), np.float64)
    for o in range(128):
        for ph, k, s in taps:
            if o % 2 == ph:
                d = (o - ph) // 2 + s - s_min
                sh[0, o, d] += lo[k]
                sh[1, o, d] += hi[k]
    sw = np.zeros((2, 256, 256), np.float64)
    for o in range(256):
        for ph, k, s in taps:
            if o % 2 == ph:
                d = (o - ph) // 2 + s - s_min
                sw[0, d, o] += lo[k]
                sw[1, d, o] += hi[k]
    return sh[0], sh[1], sw[0], sw[1], s_min, ext, khs


# ---------------------------------------------------------------------------
# plain versions: the GEMM form in plain torch
# ---------------------------------------------------------------------------


def _pad_to(t: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the last axis to ``target`` entries."""
    return t if t.shape[-1] == target else torch.nn.functional.pad(t, (0, target - t.shape[-1]))


def _gather(t: torch.Tensor, src: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """``t[..., src]``, zero where ``keep`` is False."""
    out = t.index_select(-1, src.to(t.device))
    return out if keep is None else out * keep.to(device=t.device, dtype=t.dtype)


def _windows(ext: torch.Tensor, mat: torch.Tensor, step: int, nblk: int) -> torch.Tensor:
    """``ext[..., step*j : step*j + K] @ mat`` for the ``nblk`` windows:
    ``[..., nblk, N]``."""
    k = mat.shape[0]
    return _pad_to(ext, step * (nblk - 1) + k).unfold(-1, k, step) @ mat


def _analysis_axis(x, mat, block: int, m: int, pad: int, period: int, circular: bool):
    """One analysis pass along the last axis: ``(lo, hi)`` of ``m`` bands.

    ``ext[j] = X(j - pad)``, read modulo ``period`` (positions past the
    axis repeat its last sample) or zero outside it; window ``j`` of
    ``mat`` yields ``block`` lo then ``block`` hi outputs."""
    n = x.shape[-1]
    nblk = -(-m // block)
    r = torch.arange(2 * block * (nblk - 1) + mat.shape[0]) - pad
    if circular:
        src, keep = torch.clamp(torch.remainder(r, period), max=n - 1), None
    else:
        keep = (r >= 0) & (r < n)
        src = r.clamp(0, n - 1)
    out = _windows(_gather(x, src, keep), mat, 2 * block, nblk)
    lo = out[..., :block].flatten(-2)[..., :m]
    hi = out[..., block:].flatten(-2)[..., :m]
    return lo, hi


def mxu2_dwt_plain(
    x: torch.Tensor,
    lo: Sequence[float],
    hi: Sequence[float],
    per_h: int,
    per_w: int,
    m_h: int,
    m_w: int,
    pad: int,
    circular: bool = True,
) -> torch.Tensor:
    """K9a's plain version: a K1 launch's ``[B, h, w] -> [4, B, m_h, m_w]``
    (ll, lh, hl, hh; ``lh`` is hi on H) as banded-window GEMMs."""
    fw64, fh64 = _analysis_mats(tuple(lo), tuple(hi))
    fw = torch.as_tensor(fw64, dtype=x.dtype, device=x.device)
    fh_t = torch.as_tensor(fh64.T.copy(), dtype=x.dtype, device=x.device)
    # W pass: [B, h, w] -> lo, hi [B, h, m_w]
    y_lo, y_hi = _analysis_axis(x, fw, 128, m_w, pad, per_w, circular)
    # H pass on both, rows last: [2, B, m_w, h] -> [2, B, m_w, m_h]
    y = torch.stack((y_lo, y_hi)).transpose(-1, -2)
    z_lo, z_hi = _analysis_axis(y, fh_t, 64, m_h, pad, per_h, circular)
    z_lo, z_hi = z_lo.transpose(-1, -2), z_hi.transpose(-1, -2)
    return torch.stack((z_lo[0], z_hi[0], z_lo[1], z_hi[1]))


def _band_extend(band, n_ext: int, s_min: int, m: int, half: int, circular: bool):
    """``be[j] = B(j + s_min)`` along the last axis: the band rows folded
    modulo ``half`` (each also collecting rows ``+ half, + 2 half, ... <
    m``) when circular, else zero outside ``[0, m)``."""
    q = torch.arange(n_ext) + s_min
    if not circular:
        keep = (q >= 0) & (q < m)
        return _gather(band, q.clamp(0, m - 1), keep)
    folded = band[..., :half]
    for start in range(half, m, half):
        folded = folded + _pad_to(band[..., start : start + half], half)
    return _gather(folded, torch.remainder(q, half), None)


def _tail_fold(t: torch.Tensor, out: int) -> torch.Tensor:
    """Crop the last axis to ``out``, adding positions ``[out, ...)`` to
    the last one (the adjoint of a clamped read)."""
    if t.shape[-1] == out:
        return t
    tail = t[..., out - 1 :].sum(-1, keepdim=True)
    return torch.cat((t[..., : out - 1], tail), dim=-1)


def mxu2_idwt_plain(
    bands: Sequence[torch.Tensor],
    lo: Sequence[float],
    hi: Sequence[float],
    out_h: int,
    out_w: int,
    off: int,
    circular: bool,
    fold: tuple[int, int, int, int] | None = None,
) -> torch.Tensor:
    """K9b's plain version: a K2 launch's four ``[B, m_h, m_w]`` bands ->
    ``[B, out_h, out_w]`` as banded-window GEMMs, with K2's ``fold =
    (half_h, half_w, per_h, per_w)``."""
    ll = bands[0]
    m_h, m_w = ll.shape[-2:]
    half_h, half_w, per_h, per_w = fold or (m_h, m_w, out_h, out_w)
    sh_lo, sh_hi, sw_lo, sw_hi, s_min, _, khs = (
        torch.as_tensor(a, dtype=ll.dtype, device=ll.device) if isinstance(a, np.ndarray) else a
        for a in _synthesis_mats(tuple(lo), tuple(hi), off)
    )
    # H pass, rows last: out rows [128 i, 128 i + 128) read be rows [64 i, 64 i + KHs)
    nblk = -(-per_h // 128)
    stacked = torch.stack(tuple(bands)).transpose(-1, -2)  # [4, B, m_w, m_h]
    be = _band_extend(stacked, 64 * (nblk - 1) + khs, s_min, m_h, half_h, circular)
    by_lo = _windows(be, sh_lo.T, 64, nblk).flatten(-2)[..., :per_h]
    by_hi = _windows(be, sh_hi.T, 64, nblk).flatten(-2)[..., :per_h]
    wl = (by_lo[0] + by_hi[1]).transpose(-1, -2)  # SH_lo ll + SH_hi lh: [B, per_h, m_w]
    wh = (by_lo[2] + by_hi[3]).transpose(-1, -2)  # SH_lo hl + SH_hi hh
    # W pass: out cols [256 j, 256 j + 256) read be cols [128 j, 128 j + 256)
    nblk = -(-per_w // 256)
    n_ext = 128 * (nblk - 1) + 256
    out = _windows(_band_extend(wl, n_ext, s_min, m_w, half_w, circular), sw_lo, 128, nblk)
    out = out + _windows(_band_extend(wh, n_ext, s_min, m_w, half_w, circular), sw_hi, 128, nblk)
    out = _tail_fold(out.flatten(-2)[..., :per_w], out_w)
    out = _tail_fold(out[..., :per_h, :].transpose(-1, -2), out_h).transpose(-1, -2)
    return out.contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _plan_array(plan: tuple):
    """The host copy of a plan the C entry point takes, made once per plan:
    host time between a backward's launches leaves the card idle."""
    return _kernels.int_array(plan)


def _check_float32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"K9 takes float32 only, got {name} of {t.dtype}")
    _kernels.check_tensor(name, t, torch.float32, t.device)


def mxu2_dwt_call(
    x: torch.Tensor,
    lo: Sequence[float],
    hi: Sequence[float],
    per_h: int,
    per_w: int,
    m_h: int,
    m_w: int,
    pad: int,
    circular: bool = True,
) -> torch.Tensor:
    """Launch K9a on ``[B, h, w]`` -> ``[4, B, m_h, m_w]``, a K1 launch's
    arguments and output; ``circular=False`` reads zero outside the image."""
    _check_float32("x", x)
    b, h, w = x.shape
    out = torch.empty((4, b, m_h, m_w), dtype=x.dtype, device=x.device)
    if out.numel():
        plan = analysis_plan(len(lo), pad, m_h, m_w)
        _kernels.launch(
            "K9a", "ptwt_mxu2d_analysis", x.device, x.dtype,
            x, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            b, h, w, per_h, per_w, m_h, m_w, pad, int(circular),
            _plan_array(plan), len(plan),
        )
    return out


def mxu2_idwt_call(
    bands: Sequence[torch.Tensor],
    lo: Sequence[float],
    hi: Sequence[float],
    out_h: int,
    out_w: int,
    off: int,
    circular: bool,
    fold: tuple[int, int, int, int] | None = None,
) -> torch.Tensor:
    """Launch K9b on four ``[B, m_h, m_w]`` bands -> ``[B, out_h, out_w]``,
    a K2 launch's arguments and output (``fold`` as K2's)."""
    ref = bands[0]
    for name, t in zip(("ll", "lh", "hl", "hh"), bands):
        _check_float32(name, t)
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError(f"all subbands must share one shape and device, got {t.shape} and {ref.shape}")
    b, m_h, m_w = ref.shape
    fold = fold or (m_h, m_w, out_h, out_w)
    out = torch.empty((b, out_h, out_w), dtype=ref.dtype, device=ref.device)
    if out.numel():
        plan = synthesis_plan(len(lo), off, off, m_h, m_w, out_h, out_w)
        _kernels.launch(
            "K9b", "ptwt_mxu2d_synthesis", ref.device, ref.dtype,
            *bands, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            b, m_h, m_w, out_h, out_w, off, off, int(circular), *fold,
            _plan_array(plan), len(plan),
        )
    return out

