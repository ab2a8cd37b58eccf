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
  each level as a column pass then a row pass, writing every ``lh``/
  ``hl``/``hh`` position it owns once and ``ll`` at the run's last level;
  a K5b block owns a tile of the run's finest output.  Where an image fits
  a block, one block holds the whole image and runs the levels with no
  halo (the JAX package's K5 design, for small images), on a persistent
  grid that stages the next image during the current one; else a run is
  one level of wide tiles (at most 16 x 512 level-0 positions; K5b 22 x
  256 outputs), one block each.  :func:`_pyramid2d_runs` picks each run's
  depth and tile from the filter length, the item size and the image
  size.  Each band has a tensor of its own: the JAX package's quadrant
  layout and its concat cascade are TPU artifacts with no counterpart
  here.
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
make them: each launch is one custom op (``wavedec1d_run``,
``waverec1d_run``, ``wavedec2d_run``, ``waverec2d_run`` in
``torch.ops.ptwt_tpu_torch``, :mod:`._library`), whose backward is the
opposite op, one launch of the opposite kernel (counted under it), so a
second backward runs the pair again.  A filter tensor that requires grad
raises on the card.

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

from ..utils._preprocess import host_constant
from . import _kernels
from ._library import NAMESPACE, autograd, call, flatten_batch, flatten_list, split_batch
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
    and the kernels hold the filter.  An odd-length bank declines: pywt's
    periodization then gives bands of ``(n + L - 1) // 2 - L // 2 + ...``
    other than ``n / 2`` (31 and 15 on 64 samples at 7 taps), which the
    per-level route computes."""
    return level >= 1 and n > 0 and n % (1 << level) == 0 and _even_bank(filt_len)


def _even_bank(filt_len: int) -> bool:
    """The pyramid kernels' filter gate: an even length they hold."""
    return filt_len % 2 == 0 and 2 <= filt_len <= MAX_TAPS


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


# K6a / K6b: one run of at most four levels of the 1d pyramid, each the
# other's VJP with the same taps


@torch.library.custom_op(f"{NAMESPACE}::wavedec1d_run", mutates_args=())
def wavedec1d_run(x2: torch.Tensor, lo: list[float], hi: list[float], depth: int) -> list[torch.Tensor]:
    """K6a on ``[rows, n]``, one run of ``depth`` levels: ``[lo_D, hi_1,
    ..., hi_D]``."""
    lo_band, his = analysis_pyramid("K6a", x2, lo, hi, depth, "periodization")
    return [lo_band, *his]


@wavedec1d_run.register_fake
def _(x2, lo, hi, depth):
    rows, n = x2.shape
    return [x2.new_empty(rows, n >> depth)] + [x2.new_empty(rows, n >> lvl) for lvl in range(1, depth + 1)]


def _taps_setup(ctx, inputs, output):
    ctx.plan = tuple(inputs[1:3])


def _wavedec1d_backward(ctx, cts):
    """One K6b launch with the same (flipped dec) taps and offsets."""
    lo, hi = ctx.plan
    ct_lo, *ct_his = cts
    bands = [c.contiguous() for c in (ct_lo, *ct_his[::-1])]
    return call(waverec1d_run, bands, lo, hi), None, None, None


@wavedec1d_run.register_vmap
def _(info, in_dims, x2, lo, hi, depth):
    size = info.batch_size
    outs = wavedec1d_run(flatten_batch(x2, in_dims[0], size), lo, hi, depth)
    return [split_batch(t, size) for t in outs], [0] * len(outs)


@torch.library.custom_op(f"{NAMESPACE}::waverec1d_run", mutates_args=())
def waverec1d_run(bands: list[torch.Tensor], lo: list[float], hi: list[float]) -> torch.Tensor:
    """K6b on ``[lo_D, hi_D, ..., hi_1]``, each ``[rows, m_l]`` -> ``[rows,
    2 m_1]``."""
    offs = [len(lo) // 2 - 1] * (len(bands) - 1)
    return synthesis_pyramid("K6b", bands, lo, hi, offs, 2 * bands[-1].shape[-1], True)


@waverec1d_run.register_fake
def _(bands, lo, hi):
    return bands[0].new_empty(bands[0].shape[0], 2 * bands[-1].shape[-1])


def _waverec1d_setup(ctx, inputs, output):
    bands, lo, hi = inputs
    ctx.plan = (lo, hi, len(bands) - 1)


def _waverec1d_backward(ctx, ct):
    """One K6a launch with the same (rec) taps."""
    lo, hi, depth = ctx.plan
    lo_band, *his = call(wavedec1d_run, ct.contiguous(), lo, hi, depth)
    return [lo_band, *his[::-1]], None, None


@waverec1d_run.register_vmap
def _(info, in_dims, bands, lo, hi):
    size = info.batch_size
    return split_batch(waverec1d_run(flatten_list(bands, in_dims[0], size), lo, hi), size), 0


autograd(wavedec1d_run, _taps_setup, _wavedec1d_backward)
autograd(waverec1d_run, _waverec1d_setup, _waverec1d_backward)


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
        cur, *run = call(wavedec1d_run, cur, lo, hi, depth)
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
        cur = call(waverec1d_run, [cur, *his], lo, hi)
        done += depth
    return cur


# ---------------------------------------------------------------------------
# K5: the 2d pyramid -- plan
# ---------------------------------------------------------------------------

#: Deepest run of one launch (``PYR2D_MAX_DEPTH`` of ``csrc/pyramid2d.cu``):
#: a whole image.
MAX_PYRAMID2D_DEPTH = 8
#: Deepest run of a tiled launch (``PYR2D_MAX_TILED_DEPTH``): on the card,
#: tiled runs of depth 2-4 were slower than depth-1 runs at every
#: configuration swept.
MAX_TILED_DEPTH = 1
#: Most level-0 rows and columns of an analysis tile (``2 th``, ``2 tw``):
#: wide tiles read long row segments.
_TILE_ROWS, _TILE_COLS = 16, 512
#: Most an analysis cone may read, over its tile's own input.
_MAX_CONE_READ = 2.0
#: Most output rows and columns of a synthesis tile: its column pass
#: computes four output-row pairs an item, and 22 rows (8 k - 2) fill
#: three items per column whatever the parity of the tile's first row.
_SYN_ROWS, _SYN_COLS = 22, 256
#: Shared memory one block may use on the H100 (bytes).
_SMEM_LIMIT = 232448
#: A tiled block within this leaves room for three on an SM (228 KB, 1 KB
#: of it reserved per block); the plan takes a tile within it first, and
#: the limit only where none fits.
_SMEM_TARGET = 75 * 1024
#: The same for a synthesis block.
_SYN_SMEM_TARGET = 75 * 1024
#: Rows and columns past a synthesis tile's band range (``PYR2D_SLACK``).
_SLACK = 4

_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


# The shared-memory layouts of ``csrc/pyramid2d.cu`` (``analysis_need``,
# ``synthesis_need``), in elements; see there.


def _cone_at(t: int, size: int, le: int, whole: bool, depth: int, lvl: int) -> int:
    """Cone length along one axis at level ``lvl`` of an analysis run (``Le``
    = the filter length rounded up to even); a whole image's band."""
    if whole:
        return size >> lvl
    c = t
    for _ in range(depth - lvl):
        c = 2 * c + le - 2
    return c


def _reach(c_out: int, c_in: int, le: int, whole: bool) -> int:
    """Positions of a line that the four-output windows of ``c_out``
    outputs read."""
    return c_in if whole else 8 * ((c_out + 3) // 4) + le - 2


def _analysis_need(depth, h, w, th, tw, whole, filt_len, itemsize) -> tuple[int, int]:
    le = filt_len + (filt_len & 1)
    v = 16 // itemsize
    ch = [_cone_at(th, h, le, whole, depth, lv) for lv in range(depth + 1)]
    cw = [_cone_at(tw, w, le, whole, depth, lv) for lv in range(depth + 1)]
    a = _reach(ch[1], ch[0], le, whole) * _round(cw[0] + v - 1, v)
    b = 0
    for lv in range(1, depth + 1):
        rows_ll = _reach(ch[lv + 1], ch[lv], le, whole) if lv < depth else ch[lv]
        a = max(a, (rows_ll + 3 * ch[lv]) * (_round(cw[lv], 4) + 1))
        b = max(b, 2 * ch[lv] * (_reach(cw[lv], cw[lv - 1], le, whole) | 1))
    return _round(a, 4), b


def _span_at(t: int, size: int, filt_len: int, whole: bool, lvl: int) -> int:
    """Bound on a synthesis tile's band range at level ``lvl``."""
    if whole:
        return size >> lvl
    n = t
    for _ in range(lvl):
        n = (n + filt_len - 1) // 2 + 1
    return n


def _alloc_at(t: int, size: int, filt_len: int, whole: bool, lvl: int) -> int:
    return _span_at(t, size, filt_len, whole, lvl) + (0 if whole else _SLACK)


def _synthesis_need(depth, h, w, th, tw, whole, filt_len, itemsize) -> tuple[int, int]:
    v = 16 // itemsize

    def band(lv):
        return _alloc_at(th, h, filt_len, whole, lv) * _round(_alloc_at(tw, w, filt_len, whole, lv) + v - 1, v)

    bands = band(depth) + 3 * sum(band(lv) for lv in range(1, depth + 1))
    out = _span_at(th, h, filt_len, whole, 0) * (_span_at(tw, w, filt_len, whole, 0) | 1)
    low = max(
        2 * _span_at(th, h, filt_len, whole, lv - 1) * (_alloc_at(tw, w, filt_len, whole, lv) | 1)
        for lv in range(1, depth + 1)
    )
    ll = _alloc_at(th, h, filt_len, whole, 1) * (_alloc_at(tw, w, filt_len, whole, 1) | 1) if depth > 1 else 0
    return _round(max(bands, out), 4), ll + low


def _halvings(n: int):
    """``n``, ``n // 2``, ..., 1."""
    while n >= 1:
        yield n
        n >>= 1


def _analysis_tile(h: int, w: int, filt_len: int, itemsize: int, limit: int, cap):
    """``(th, tw)`` of a tiled (depth-1) K5a run, or None.

    A tile of ``th x tw`` level-1 positions (at most :data:`_TILE_ROWS` x
    :data:`_TILE_COLS` at level 0, clamped to the band; up to
    :data:`_TILE_COLS` rows where no such tile suits) reads a cone of
    :func:`_cone_at` samples per axis at level 0.  The widest, then
    tallest tile whose buffers fit ``limit`` bytes and whose cone reads at
    most ``cap`` times the tile's own input (no cap where ``cap`` is None)
    is taken.
    """
    le = filt_len + (filt_len & 1)
    for most_rows in (_TILE_ROWS, _TILE_COLS):  # taller tiles where wide ones read too much
        for cols in _halvings(_TILE_COLS >> 1):
            for rows in _halvings(most_rows >> 1):
                th, tw = min(rows, h >> 1), min(cols, w >> 1)
                reads = _cone_at(th, h, le, False, 1, 0) * _cone_at(tw, w, le, False, 1, 0)
                a, b = _analysis_need(1, h, w, th, tw, False, filt_len, itemsize)
                if (a + b) * itemsize <= limit and (cap is None or reads <= cap * 4 * th * tw):
                    return th, tw
    return None


def _synthesis_tile(h: int, w: int, filt_len: int, itemsize: int):
    """``(th, tw)`` of a tiled (depth-1) K5b run: the widest, then tallest
    of at most :data:`_SYN_ROWS` x :data:`_SYN_COLS` outputs whose buffers
    fit :data:`_SYN_SMEM_TARGET`, else the limit, or None."""
    for limit in (_SYN_SMEM_TARGET, _SMEM_LIMIT):
        for cols in _halvings(_SYN_COLS):
            for rows in _halvings(_SYN_ROWS):
                th, tw = min(rows, h), min(cols, w)
                a, b = _synthesis_need(1, h, w, th, tw, False, filt_len, itemsize)
                if (a + b) * itemsize <= limit:
                    return th, tw
    return None


def _whole_fits(h: int, w: int, filt_len: int, depth: int, itemsize: int) -> bool:
    """Do the image and both kernels' buffers fit one block (one staging
    buffer)?"""
    ana = sum(_analysis_need(depth, h, w, h >> depth, w >> depth, True, filt_len, itemsize))
    syn = sum(_synthesis_need(depth, h, w, h, w, True, filt_len, itemsize))
    return max(ana, syn) * itemsize <= _SMEM_LIMIT


def _bufs(a: int, b: int, itemsize: int, whole: bool) -> int:
    """Staging buffers of a launch: two for whole images where they fit a
    block (a persistent grid, the next image staged during the current
    one), else one (one block per tile)."""
    return 2 if whole and (2 * a + b) * itemsize <= _SMEM_LIMIT else 1


@functools.lru_cache(maxsize=256)
def _run_mode(h: int, w: int, filt_len: int, depth: int, itemsize: int):
    """How a run of ``depth`` levels of ``[h, w]`` images runs: ``(True,
    h >> depth, w >> depth)`` for a whole image, ``(False, th, tw)`` tiled
    (K5a's tile), or None.

    A whole image where it fits a block; else (depth 1 only) the tile
    whose cone reads within :data:`_MAX_CONE_READ`, within the target,
    then within the limit; and where an image of ``2 h w`` elements fits a
    block but neither does, a tile with no cap on its cone (long filters
    on small images).
    """
    if depth <= MAX_PYRAMID2D_DEPTH and _whole_fits(h, w, filt_len, depth, itemsize):
        return True, h >> depth, w >> depth
    if depth > MAX_TILED_DEPTH or _synthesis_tile(h, w, filt_len, itemsize) is None:
        return None
    for limit in (_SMEM_TARGET, _SMEM_LIMIT):
        tile = _analysis_tile(h, w, filt_len, itemsize, limit, _MAX_CONE_READ)
        if tile is not None:
            return (False, *tile)
    if 2 * h * w * itemsize <= _SMEM_LIMIT:
        tile = _analysis_tile(h, w, filt_len, itemsize, _SMEM_LIMIT, None)
        if tile is not None:
            return (False, *tile)
    return None


@host_constant(maxsize=256)  # the gates call it under torch.compile: a constant of the program
def _pyramid2d_runs(h: int, w: int, filt_len: int, level: int, itemsize: int):
    """Depths of the K5 launches of a ``level``-level pyramid of ``[h, w]``
    images, fine to coarse, or None where the plan does not hold it.

    Each run is a whole image, as deep as it goes, where it fits a block
    (the JAX package's K5 design), else one tiled level; a level that
    neither holds declines the pyramid.
    """
    runs = []
    while level > 0:
        depth = min(level, MAX_PYRAMID2D_DEPTH)
        if not _whole_fits(h, w, filt_len, depth, itemsize):
            depth = 1
            if _run_mode(h, w, filt_len, 1, itemsize) is None:
                return None
        runs.append(depth)
        h, w, level = h >> depth, w >> depth, level - depth
    return tuple(runs)


def fused_wavedec2d_applicable(h: int, w: int, filt_len: int, level: int, dtype) -> bool:
    """Static gate: ``level`` periodization levels halve ``[h, w]`` exactly,
    the kernels hold the filter (an even length: an odd bank's bands are
    not half the axis, as for K6), and the plan holds every run."""
    if level < 1 or h < 1 or w < 1 or h % (1 << level) or w % (1 << level):
        return False
    if not _even_bank(filt_len) or dtype not in _ITEMSIZE:
        return False
    return _pyramid2d_runs(h, w, filt_len, level, _ITEMSIZE[dtype]) is not None


@functools.lru_cache(maxsize=256)
def _analysis_plan(h: int, w: int, filt_len: int, depth: int, itemsize: int):
    """``(ints, smem_bytes)`` of one K5a launch on ``[h, w]`` images.

    ``ints`` is ``Pyramid2dPlan`` of ``csrc/pyramid2d.cu``: ``depth, h, w,
    th, tw, tiles_h, tiles_w, whole, pad, buf_a, buf_b, bufs``.  Tiles are
    aligned at the deepest level: tile ``(ty, tx)`` owns level-``l``
    positions ``[ty th 2^(D-l), (ty+1) th 2^(D-l))`` (clamped to the band)
    and the same along W, so every band position has one owner.
    """
    mode = _run_mode(h, w, filt_len, depth, itemsize)
    if mode is None:
        raise ValueError(f"no K5a tile holds {depth} levels of {filt_len} taps on [{h}, {w}]")
    whole, th, tw = mode
    buf_a, buf_b = _analysis_need(depth, h, w, th, tw, whole, filt_len, itemsize)
    tiles_h = -(-(h >> depth) // th)
    tiles_w = -(-(w >> depth) // tw)
    bufs = _bufs(buf_a, buf_b, itemsize, whole)
    ints = (depth, h, w, th, tw, tiles_h, tiles_w, int(whole), filt_len // 2 - 1, buf_a, buf_b, bufs)
    return ints, (bufs * buf_a + buf_b) * itemsize


@functools.lru_cache(maxsize=256)
def _synthesis_plan(h: int, w: int, filt_len: int, depth: int, itemsize: int):
    """``(ints, smem_bytes)`` of one K5b launch writing ``[h, w]`` images.

    A tile owns ``th x tw`` outputs; step ``l`` reads its bands over
    ``c_l = floor((c_{l-1} + pad - (L-1)) / 2)`` to ``e_l = floor((e_{l-1}
    + pad) / 2)`` per axis, at most ``n_l = (n_{l-1} + L - 1) // 2 + 1``
    positions.  The run is whole or tiled as its analysis run is.
    """
    mode = _run_mode(h, w, filt_len, depth, itemsize)
    if mode is None:
        raise ValueError(f"no K5b tile holds {depth} steps of {filt_len} taps on [{h}, {w}]")
    whole = mode[0]
    th, tw = (h, w) if whole else _synthesis_tile(h, w, filt_len, itemsize)
    buf_a, buf_b = _synthesis_need(depth, h, w, th, tw, whole, filt_len, itemsize)
    bufs = _bufs(buf_a, buf_b, itemsize, whole)
    ints = (depth, h, w, th, tw, -(-h // th), -(-w // tw), int(whole), filt_len // 2 - 1, buf_a, buf_b, bufs)
    return ints, (bufs * buf_a + buf_b) * itemsize


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


# K5a / K5b: one run of the 2d pyramid, each the other's VJP with the same
# taps and run plan


@torch.library.custom_op(f"{NAMESPACE}::wavedec2d_run", mutates_args=())
def wavedec2d_run(x3: torch.Tensor, lo: list[float], hi: list[float], depth: int) -> list[torch.Tensor]:
    """K5a on ``[B, h, w]``, one run of ``depth`` levels: ``[ll_D, lh_1,
    hl_1, hh_1, ..., hh_D]``."""
    ll, details = _analysis_run("K5a", x3, lo, hi, depth)
    return [ll, *details]


@wavedec2d_run.register_fake
def _(x3, lo, hi, depth):
    b, h, w = x3.shape
    return [x3.new_empty(b, h >> depth, w >> depth)] + [
        x3.new_empty(b, h >> lvl, w >> lvl) for lvl in range(1, depth + 1) for _ in range(3)
    ]


def _wavedec2d_backward(ctx, cts):
    """One K5b launch with the same (flipped dec) taps and run plan."""
    lo, hi = ctx.plan
    return call(waverec2d_run, [c.contiguous() for c in cts], lo, hi), None, None, None


@wavedec2d_run.register_vmap
def _(info, in_dims, x3, lo, hi, depth):
    size = info.batch_size
    outs = wavedec2d_run(flatten_batch(x3, in_dims[0], size), lo, hi, depth)
    return [split_batch(t, size) for t in outs], [0] * len(outs)


@torch.library.custom_op(f"{NAMESPACE}::waverec2d_run", mutates_args=())
def waverec2d_run(bands: list[torch.Tensor], lo: list[float], hi: list[float]) -> torch.Tensor:
    """K5b on ``[ll_D, lh_1, hl_1, hh_1, ..., hh_D]`` -> ``[B, h, w]``."""
    return _synthesis_run("K5b", bands[0], bands[1:], lo, hi)


@waverec2d_run.register_fake
def _(bands, lo, hi):
    b, mh, mw = bands[0].shape
    depth = (len(bands) - 1) // 3
    return bands[0].new_empty(b, mh << depth, mw << depth)


def _waverec2d_setup(ctx, inputs, output):
    bands, lo, hi = inputs
    ctx.plan = (lo, hi, (len(bands) - 1) // 3)


def _waverec2d_backward(ctx, ct):
    """One K5a launch with the same (rec) taps and run plan."""
    lo, hi, depth = ctx.plan
    return call(wavedec2d_run, ct.contiguous(), lo, hi, depth), None, None


@waverec2d_run.register_vmap
def _(info, in_dims, bands, lo, hi):
    size = info.batch_size
    return split_batch(waverec2d_run(flatten_list(bands, in_dims[0], size), lo, hi), size), 0


autograd(wavedec2d_run, _taps_setup, _wavedec2d_backward)
autograd(waverec2d_run, _waverec2d_setup, _waverec2d_backward)


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
        cur, *details = call(wavedec2d_run, cur, lo, hi, depth)
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
        cur = call(waverec2d_run, [cur, *details], lo, hi)
    return cur.reshape(*lead, h, w)
