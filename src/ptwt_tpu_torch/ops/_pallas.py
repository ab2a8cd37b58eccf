"""The whole periodization pyramid: kernels K5a/K5b (2d) and K6a/K6b (1d).

Counterpart of :mod:`ptwt_tpu.ops._pallas`, whose Pallas kernels keep an
image's or a batch row's entire level pyramid in VMEM: the analysis
carries only the ``lo``/``ll`` chain between levels and writes each
detail band once, the synthesis runs the inverse.  The H100 gives a
block 227 KB of shared memory, so here a pyramid is cut into runs of
levels, each one launch of a tile-fused kernel that reads its input
modulo the band size.  On an exactly halving chain every level is
periodic in its own size, so every cone value is exact and no edge pass
is needed:

* **K5a/K5b** (``csrc/pyramid2d.cu``) -- the 2d pyramid.  A K5a block
  owns a tile of the run's deepest band, stages its input cone and runs
  each level as a row pass then a column pass, writing every ``lh``/
  ``hl``/``hh`` position it owns once and ``ll`` at the run's last level;
  a K5b block owns a tile of the run's finest output.  Where the image
  and its buffers fit in shared memory, one block holds the whole image
  and runs the levels with no halo (the JAX package's K5 design, for
  small images).  :func:`_pyramid2d_runs` picks each run's depth and
  tile from the filter length, the item size and the image size.  Each
  band has a tensor of its own: the JAX package's quadrant layout and
  its concat cascade are TPU artifacts with no counterpart here.
* **K6a/K6b** (``csrc/fwt1d.cu``, the circular instances of the K8
  pyramid kernels of :mod:`._pallas1d_multi`) -- the 1d pyramid in runs
  of at most four levels.

The gates keep the JAX package's semantics (``periodization`` on an
exactly halving chain) and drop its Mosaic limits (float32 only,
power-of-two sizes, the VMEM and tile limits).  The JAX 2d gate also
defers to the per-level kernels wherever they qualify, from a TPU
measurement; no TPU number carries over, so the port sends every chain
its plan holds to K5, and the per-level route (K1/K2, K3/K4) keeps what
the plan declines (a filter too long for a depth-1 cone of tolerable
size).

Gradients: the analysis and synthesis of a run are each other's VJP with
the same taps and the same run plan, as the JAX package's ``custom_vjp``s
make them: one :class:`torch.autograd.Function` per launch, whose
backward is one launch of the opposite kernel (counted under it).  A
filter tensor that requires grad raises on the card, and so does a
double backward.

The plain versions run the levels one by one through
:func:`~._pallas2d.dwt2_level_plain` / :func:`~._pallas2d.idwt2_level_plain`
(2d) and :func:`~._pallas2.dwt_axis_plain` / :func:`~._pallas2.idwt_axis_plain`
(1d); the wrappers take them for CPU tensors only, where they are
autograd-transparent, filters included.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from . import _kernels
from ._pallas1d_multi import MAX_FUSED_DEPTH, MAX_TAPS, analysis_pyramid, synthesis_pyramid
from ._pallas2 import _on_cpu, dwt_axis_plain, idwt_axis_plain
from ._pallas2d import dwt2_level_plain, idwt2_level_plain

__all__ = [
    "fused_wavedec1d_per",
    "fused_wavedec2d_applicable",
    "fused_wavedec2d_per",
    "fused_wavedec_applicable",
    "fused_waverec1d_per",
    "fused_waverec2d_per",
    "wavedec1d_per_plain",
    "wavedec2d_per_plain",
    "waverec1d_per_plain",
    "waverec2d_per_plain",
]


# ---------------------------------------------------------------------------
# K6: the 1d pyramid
# ---------------------------------------------------------------------------


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


class _Wavedec1dRun(torch.autograd.Function):
    """K6a forward on ``[rows, n]``, one run of ``depth`` levels; backward:
    one K6b launch with the same (flipped dec) taps and offsets."""

    @staticmethod
    def forward(ctx, x2, lo, hi, depth):
        ctx.plan = (lo, hi, depth, x2.shape[-1])
        lo_band, his = analysis_pyramid("K6a", x2, lo, hi, depth, "periodization")
        return (lo_band, *his)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_lo, *ct_his):
        lo, hi, depth, n = ctx.plan
        bands = [c.contiguous() for c in (ct_lo, *ct_his[::-1])]
        grad = synthesis_pyramid("K6b", bands, lo, hi, [len(lo) // 2 - 1] * depth, n, True)
        return grad, None, None, None


class _Waverec1dRun(torch.autograd.Function):
    """K6b forward on ``[lo_D, hi_D, ..., hi_1]``; backward: one K6a launch
    with the same (rec) taps."""

    @staticmethod
    def forward(ctx, lo, hi, *bands):
        depth = len(bands) - 1
        ctx.plan = (lo, hi, depth)
        offs = [len(lo) // 2 - 1] * depth
        return synthesis_pyramid("K6b", bands, lo, hi, offs, 2 * bands[-1].shape[-1], True)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        lo, hi, depth = ctx.plan
        lo_band, his = analysis_pyramid("K6a", ct.contiguous(), lo, hi, depth, "periodization")
        return (None, None, lo_band, *his[::-1])


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
    cur = data.contiguous()
    his: list[torch.Tensor] = []
    for depth in _runs(level):
        cur, *run = _Wavedec1dRun.apply(cur, lo, hi, depth)
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
    cur = coeffs[0].contiguous()
    done = 0
    for depth in _runs(len(coeffs) - 1)[::-1]:  # coarse to fine
        his = [c.contiguous() for c in coeffs[1 + done : 1 + done + depth]]
        cur = _Waverec1dRun.apply(lo, hi, cur, *his)
        done += depth
    return cur


# ---------------------------------------------------------------------------
# K5: the 2d pyramid -- plan
# ---------------------------------------------------------------------------

#: Deepest run of one launch (``PYR2D_MAX_DEPTH`` of ``csrc/pyramid2d.cu``).
MAX_PYRAMID2D_DEPTH = 8
#: Deepest run of a tiled launch: a depth-4 cone of db4 does not fit.
MAX_TILED_DEPTH = 4
#: Level-0 side of an analysis tile (``T << D``), as the 1d kernels' 4096.
_TILE_SIDE = 128
#: Most an analysis cone may read, over its tile's own input.
_MAX_CONE_READ = 2.0
#: Output tiles a synthesis block may own, largest first.
_SYN_TILES = (64, 32, 16, 8, 4, 2, 1)
#: Shared memory one block may use on the H100 (bytes).
_SMEM_LIMIT = 232448
#: An analysis tile within this fits three or four 512-thread blocks on an
#: SM; on the card those beat deeper runs of one 227 KB block per SM (a
#: sweep of tiles and depths at [16, 1024, 1024] db4 float32), so the plan
#: takes the deepest run within it first, and the limit only where no
#: depth fits.
_SMEM_TARGET = 64 * 1024

_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def _cone(t: int, depth: int, lvl: int, filt_len: int) -> int:
    """Length along one axis of an analysis tile's cone at level ``lvl``,
    for a tile of ``t`` level-``depth`` positions."""
    return (t << (depth - lvl)) + (filt_len - 2) * ((1 << (depth - lvl)) - 1)


def _whole(h: int, w: int, itemsize: int) -> bool:
    """Do the image and its working buffers fit one block?  Both kernels
    need ``2 h w`` elements for a whole image."""
    return 2 * h * w * itemsize <= _SMEM_LIMIT


def _analysis_tile(h: int, w: int, filt_len: int, depth: int, itemsize: int, limit: int):
    """``(th, tw, buf_a, buf_b)`` of a tiled K5a run, or None.

    A tile of ``T`` level-``depth`` positions per axis (clamped to the
    band) reads a cone of :func:`_cone` samples per axis at level 0; the
    block keeps that cone (``buf_a``) and the level-1 row pass's lo and hi
    (``buf_b`` each).  The largest ``T`` with ``T << depth <= 128`` whose
    buffers fit ``limit`` bytes and whose cone reads at most twice the
    tile's own input is taken.
    """
    t = _TILE_SIDE >> depth
    while t >= 1:
        th, tw = min(t, h >> depth), min(t, w >> depth)
        ch0, cw0 = _cone(th, depth, 0, filt_len), _cone(tw, depth, 0, filt_len)
        cw1 = _cone(tw, depth, 1, filt_len)
        reads = ch0 * cw0 / ((th << depth) * (tw << depth))
        buf_a, buf_b = ch0 * cw0, ch0 * cw1
        if (buf_a + 2 * buf_b) * itemsize <= limit and reads <= _MAX_CONE_READ:
            return th, tw, buf_a, buf_b
        t >>= 1
    return None


def _tiled(h: int, w: int, filt_len: int, level: int, itemsize: int):
    """Depth of the next tiled run: the deepest with a tile within
    :data:`_SMEM_TARGET`, else the deepest within the limit, else None."""
    for limit in (_SMEM_TARGET, _SMEM_LIMIT):
        for depth in range(min(level, MAX_TILED_DEPTH), 0, -1):
            if _analysis_tile(h, w, filt_len, depth, itemsize, limit) is not None:
                return depth
    return None


def _tile_for(h: int, w: int, filt_len: int, depth: int, itemsize: int):
    """The tile :func:`_tiled` found for a run of ``depth`` levels."""
    for limit in (_SMEM_TARGET, _SMEM_LIMIT):
        tile = _analysis_tile(h, w, filt_len, depth, itemsize, limit)
        if tile is not None:
            return tile
    return None


@functools.lru_cache(maxsize=256)
def _pyramid2d_runs(h: int, w: int, filt_len: int, level: int, itemsize: int):
    """Depths of the K5 launches of a ``level``-level pyramid of ``[h, w]``
    images, fine to coarse, or None where the plan does not hold it.

    A run holds the whole image where it fits one block (up to
    :data:`MAX_PYRAMID2D_DEPTH` levels), else the deepest tiled run
    (at most :data:`MAX_TILED_DEPTH` levels) that :func:`_tiled` accepts.
    Every run must be planned, or the pyramid is declined.
    """
    runs = []
    while level > 0:
        if _whole(h, w, itemsize):
            depth = min(level, MAX_PYRAMID2D_DEPTH)
        else:
            depth = _tiled(h, w, filt_len, level, itemsize)
            if depth is None:
                return None
        runs.append(depth)
        h, w, level = h >> depth, w >> depth, level - depth
    return tuple(runs)


def fused_wavedec2d_applicable(h: int, w: int, filt_len: int, level: int, dtype) -> bool:
    """Static gate: ``level`` periodization levels halve ``[h, w]`` exactly,
    the kernels hold the filter, and the plan holds every run."""
    if level < 1 or h < 1 or w < 1 or h % (1 << level) or w % (1 << level):
        return False
    if not 2 <= filt_len <= MAX_TAPS or dtype not in _ITEMSIZE:
        return False
    return _pyramid2d_runs(h, w, filt_len, level, _ITEMSIZE[dtype]) is not None


@functools.lru_cache(maxsize=256)
def _analysis_plan(h: int, w: int, filt_len: int, depth: int, itemsize: int):
    """``(ints, smem_bytes)`` of one K5a launch on ``[h, w]`` images.

    ``ints`` is ``Pyramid2dPlan`` of ``csrc/pyramid2d.cu``: ``depth, h, w,
    th, tw, tiles_h, tiles_w, whole, pad, buf_a, buf_b``.  Tiles are
    aligned at the deepest level: tile ``(ty, tx)`` owns level-``l``
    positions ``[ty th 2^(D-l), (ty+1) th 2^(D-l))`` (clamped to the band)
    and the same along W, so every band position has one owner.
    """
    if _whole(h, w, itemsize):
        th, tw = h >> depth, w >> depth
        whole, buf_a, buf_b = 1, h * w, h * (w // 2)
    else:
        tile = _tile_for(h, w, filt_len, depth, itemsize)
        if tile is None:
            raise ValueError(f"no K5a tile holds {depth} levels of {filt_len} taps on [{h}, {w}]")
        th, tw, buf_a, buf_b = tile
        whole = 0
    tiles_h = -(-(h >> depth) // th)
    tiles_w = -(-(w >> depth) // tw)
    ints = (depth, h, w, th, tw, tiles_h, tiles_w, whole, filt_len // 2 - 1, buf_a, buf_b)
    return ints, (buf_a + 2 * buf_b) * itemsize


@functools.lru_cache(maxsize=256)
def _synthesis_plan(h: int, w: int, filt_len: int, depth: int, itemsize: int):
    """``(ints, smem_bytes)`` of one K5b launch writing ``[h, w]`` images.

    A tile owns ``th x tw`` outputs; step ``l`` reads its bands over
    ``c_l = floor((c_{l-1} + pad - (L-1)) / 2)`` to ``e_l = floor((e_{l-1}
    + pad) / 2)`` per axis, at most ``n_l = (n_{l-1} + L - 1) // 2 + 1``
    positions.  The block keeps four band slots (``buf_a`` each: the
    largest ``n_l`` block) and the H pass's lo and hi (``buf_b`` each).
    """
    if _whole(h, w, itemsize):
        ints = (depth, h, w, h, w, 1, 1, 1, filt_len // 2 - 1, (h // 2) * (w // 2), h * (w // 2))
        return ints, 2 * h * w * itemsize
    for t in _SYN_TILES:
        nh, nw = [min(t, h)], [min(t, w)]
        for _ in range(depth):
            nh.append((nh[-1] + filt_len - 1) // 2 + 1)
            nw.append((nw[-1] + filt_len - 1) // 2 + 1)
        buf_a = max(a * b for a, b in zip(nh[1:], nw[1:]))
        buf_b = max(a * b for a, b in zip(nh[:-1], nw[1:]))
        smem = (4 * buf_a + 2 * buf_b) * itemsize
        if smem <= _SMEM_LIMIT:
            th, tw = nh[0], nw[0]
            ints = (depth, h, w, th, tw, -(-h // th), -(-w // tw), 0, filt_len // 2 - 1, buf_a, buf_b)
            return ints, smem
    raise ValueError(f"no K5b tile holds {depth} steps of {filt_len} taps on [{h}, {w}]")


# ---------------------------------------------------------------------------
# K5: plain versions
# ---------------------------------------------------------------------------


def wavedec2d_per_plain(data: torch.Tensor, dec_lo, dec_hi, level: int) -> list:
    """Level-by-level 2d periodization analysis: ``[cA, (lh, hl, hh)_level,
    ..., (lh, hl, hh)_1]``."""
    levels = []
    cur = data
    for _ in range(level):
        cur, *details = dwt2_level_plain(cur, dec_lo, dec_hi, "periodization")
        levels.append(tuple(details))
    return [cur, *levels[::-1]]


def waverec2d_per_plain(coeffs, rec_lo, rec_hi) -> torch.Tensor:
    """Level-by-level 2d periodization synthesis of ``[cA, (lh, hl, hh)_L,
    ..., (lh, hl, hh)_1]``."""
    cur = coeffs[0]
    for details in coeffs[1:]:
        cur = idwt2_level_plain((cur, *details), rec_lo, rec_hi, "periodization", [(0, 0)] * 2)
    return cur


# ---------------------------------------------------------------------------
# K5: launch glue, autograd and public wrappers
# ---------------------------------------------------------------------------

_NO_DETAIL = [None] * (3 * MAX_PYRAMID2D_DEPTH)


def _analysis_run(kernel: str, x3: torch.Tensor, lo, hi, depth: int):
    """One K5a launch on ``[B, h, w]``: ``(ll_D, [lh_1, hl_1, hh_1, lh_2,
    ..., hh_D])``.  The launch counts as ``kernel``."""
    _kernels.check_tensor("x", x3, x3.dtype, x3.device)
    b, h, w = x3.shape
    ints, smem = _analysis_plan(h, w, len(lo), depth, x3.element_size())
    ll = x3.new_empty(b, h >> depth, w >> depth)
    details = [x3.new_empty(b, h >> lvl, w >> lvl) for lvl in range(1, depth + 1) for _ in range(3)]
    if b:
        _kernels.launch(
            kernel, "ptwt_pyramid2d_analysis", x3.device, x3.dtype,
            x3, ll, details + _NO_DETAIL[len(details):], _kernels.taps_array(lo),
            _kernels.taps_array(hi), len(lo), b, _kernels.int_array(ints), smem,
        )
    return ll, details


def _synthesis_run(kernel: str, ll: torch.Tensor, details: Sequence[torch.Tensor], lo, hi):
    """One K5b launch: ``ll_D`` and ``[lh_1, hl_1, hh_1, ..., hh_D]`` ->
    ``[B, h, w]``.  The launch counts as ``kernel``."""
    depth = len(details) // 3
    b, mh, mw = ll.shape
    h, w = mh << depth, mw << depth
    _kernels.check_tensor("ll", ll, ll.dtype, ll.device)
    for i, t in enumerate(details):
        _kernels.check_tensor("band", t, ll.dtype, ll.device)
        want = (b, h >> (i // 3 + 1), w >> (i // 3 + 1))
        if tuple(t.shape) != want:
            raise ValueError(f"a level-{i // 3 + 1} band has shape {tuple(t.shape)}, expected {want}")
    ints, smem = _synthesis_plan(h, w, len(lo), depth, ll.element_size())
    out = ll.new_empty(b, h, w)
    if b:
        _kernels.launch(
            kernel, "ptwt_pyramid2d_synthesis", ll.device, ll.dtype,
            ll, list(details) + _NO_DETAIL[len(details):], out, _kernels.taps_array(lo),
            _kernels.taps_array(hi), len(lo), b, _kernels.int_array(ints), smem,
        )
    return out


class _Wavedec2dRun(torch.autograd.Function):
    """K5a forward on ``[B, h, w]``, one run of ``depth`` levels; backward:
    one K5b launch with the same (flipped dec) taps and run plan."""

    @staticmethod
    def forward(ctx, x3, lo, hi, depth):
        ctx.plan = (lo, hi)
        ll, details = _analysis_run("K5a", x3, lo, hi, depth)
        return (ll, *details)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_ll, *ct_details):
        lo, hi = ctx.plan
        bands = [c.contiguous() for c in ct_details]
        return _synthesis_run("K5b", ct_ll.contiguous(), bands, lo, hi), None, None, None


class _Waverec2dRun(torch.autograd.Function):
    """K5b forward on ``ll_D`` and the run's details; backward: one K5a
    launch with the same (rec) taps and run plan."""

    @staticmethod
    def forward(ctx, lo, hi, ll, *details):
        ctx.plan = (lo, hi, len(details) // 3)
        return _synthesis_run("K5b", ll, details, lo, hi)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        lo, hi, depth = ctx.plan
        ll, details = _analysis_run("K5a", ct.contiguous(), lo, hi, depth)
        return (None, None, ll, *details)


def _plan_runs(h: int, w: int, filt_len: int, level: int, dtype) -> tuple:
    if not fused_wavedec2d_applicable(h, w, filt_len, level, dtype):
        raise ValueError(
            f"the K5 plan does not hold {level} levels of {filt_len} taps on [{h}, {w}] "
            f"{dtype}: gate with fused_wavedec2d_applicable"
        )
    return _pyramid2d_runs(h, w, filt_len, level, _ITEMSIZE[dtype])


def fused_wavedec2d_per(data: torch.Tensor, dec_lo, dec_hi, level: int) -> list:
    """Multi-level 2d periodization analysis of ``[..., h, w]``.

    Returns ``[cA, (lh, hl, hh)_level, ..., (lh, hl, hh)_1]``, the values
    and order of the level-by-level periodization ``wavedec2`` (``lh`` =
    hi along H).  ``dec_lo``/``dec_hi`` are flipped.  Gate with
    :func:`fused_wavedec2d_applicable`.  A CPU tensor runs
    :func:`wavedec2d_per_plain`; a CUDA tensor runs K5a, one launch per
    run of :func:`_pyramid2d_runs`.
    """
    if _on_cpu(data):
        return wavedec2d_per_plain(data, dec_lo, dec_hi, level)
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    lead = data.shape[:-2]
    h, w = data.shape[-2:]
    cur = data.reshape(-1, h, w).contiguous()
    levels: list = []
    for depth in _plan_runs(h, w, len(lo), level, data.dtype):
        cur, *details = _Wavedec2dRun.apply(cur, lo, hi, depth)
        levels.extend(tuple(details[3 * i : 3 * i + 3]) for i in range(depth))

    def unflat(t):
        return t.reshape(*lead, *t.shape[-2:])

    return [unflat(cur), *(tuple(unflat(t) for t in trip) for trip in levels[::-1])]


def fused_waverec2d_per(coeffs, rec_lo, rec_hi) -> torch.Tensor:
    """Multi-level 2d periodization synthesis (the inverse of
    :func:`fused_wavedec2d_per`) of ``[cA, (lh, hl, hh)_L, ..., (lh, hl,
    hh)_1]`` on an exactly halving chain.  A CPU tensor runs
    :func:`waverec2d_per_plain`; a CUDA tensor runs K5b, one launch per
    run of the analysis plan, coarse to fine."""
    if _on_cpu(coeffs[0]):
        return waverec2d_per_plain(coeffs, rec_lo, rec_hi)
    lo = _kernels.static_taps(rec_lo)
    hi = _kernels.static_taps(rec_hi)
    level = len(coeffs) - 1
    lead = coeffs[0].shape[:-2]
    mh, mw = coeffs[0].shape[-2:]
    h, w = mh << level, mw << level

    def flat(t):
        return t.reshape(-1, *t.shape[-2:]).contiguous()

    cur = flat(coeffs[0])
    fine = [coeffs[level - i] for i in range(level)]  # level 1 first
    runs = _plan_runs(h, w, len(lo), level, coeffs[0].dtype)
    start = level
    for depth in runs[::-1]:  # coarse to fine
        start -= depth
        details = [flat(t) for trip in fine[start : start + depth] for t in trip]
        cur = _Waverec2dRun.apply(lo, hi, cur, *details)
    return cur.reshape(*lead, h, w)
