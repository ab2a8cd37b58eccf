"""Fused runs of 1d levels along a long last axis: kernels K8a/K8b.

Counterpart of :mod:`ptwt_tpu.ops._pallas1d_multi`.  There, the first
``D <= 4`` analysis levels of a long signal run in one Pallas call over
stacked ``2**15``-sample windows, and XLA recomputes each level's edges
from head and tail strips and stitches them in; the last ``D`` synthesis
steps are fused the same way.  Here two hand-written CUDA kernels
(``csrc/fwt1d.cu``) do both, edges included:

* **K8a** (``analysis_pyramid_kernel``) -- a block owns a tile of level-D
  outputs, stages the tile's input cone in shared memory split by parity
  (every element its own ``cp.async``, all in flight at once), computes
  the levels in turn, four outputs per thread, and writes every band
  position it owns once, coalesced.  One extra block per row computes the
  first ``wl_l`` and last ``wr_l`` positions of every level, whose values
  depend on that level's mode extension, from head and tail strips of the
  signal.
* **K8b** (``synthesis_pyramid_kernel``) -- a block owns a tile of final
  outputs, stages every band range it reads at once, and runs the ``D``
  transposed convolutions, with each step's crop folded into its index
  range, one output pair per thread.

At depth 1 the pair carries K7's contract (:mod:`._pallas1d`), and with
circular reads K6's (:mod:`._pallas`); all of them launch through
:func:`analysis_pyramid` and :func:`synthesis_pyramid` below, which count
each launch under the name of the contract it carries.  Their
*sameshift* instances compute the interiors of the boundary-wavelet long
runs (:mod:`._boundary_long`): every level offset by the ``sameshift``
offset ``a`` on an exactly halving chain, zero outside each band, no edge
block (:func:`sameshift_analysis`, :func:`_adjoint_plan`; K8b through
:func:`flat_waverec_lane_multi` with every crop ``a``).

The static bookkeeping that is math is ported: the band lengths ``m_l``,
the interior/edge ranges (:func:`_interior_ranges`), and the read biases
as index arithmetic (:func:`_multi_plan`, :func:`_syn_plan`).  The flat
shifts, window margins, ``[8, 4096]`` tiles and lane packing are Mosaic
artifacts and have no counterpart.

Routing thresholds: :data:`FLAT_MIN_LANES` (a last axis longer than
``2**16`` samples) and :data:`MAX_FUSED_DEPTH` (runs of at most 4 levels)
are the TPU's thresholds, kept as they are; the port's bench (ROADMAP
Queue 1b item 1) will set them from the card.  Dropped, as Mosaic-only:
the float32-only gate (float32 and float64 both run), the window plan's
feasibility, and the environment knobs.  The kernels decline only what
they cannot hold: filters of more than 128 taps (the kernel-parameter
tap bank), and bands shorter than their edge strips (a signal of fewer
than about ``16 L`` samples at depth 4), which the routing gate never
sends.

Each kernel's plain version (:func:`multi_analysis_plain`,
:func:`multi_synthesis_plain`: ``depth`` levels of
:func:`~._pallas2.dwt_axis_plain` / :func:`~._pallas2.idwt_axis_plain`)
sits here; the wrappers take it for CPU tensors only.  A CUDA tensor
launches the kernel or raises.

Gradients: one custom op per launch (``lane_analysis``,
``lane_synthesis``, and ``lane_adjoint`` for K8b's VJP, in
``torch.ops.ptwt_tpu_torch``, :mod:`._library`), whose backward is one
launch of the other pyramid kernel, as K6a and K6b are each other's VJP:

* K8a (K7a) -- the synthesis pyramid kernel with the same (dec) taps and
  crops ``padl``, run as a gather; for the padded modes an edge block per
  row also folds the transpose of pywt's extension back onto the bands'
  ends (``periodic`` couples the two ends).  It counts as K8b (K7b).
* K8b (K7b) -- the analysis pyramid kernel with the same (rec) taps, each
  level offset by its step's crop and read zero outside its band.  It
  counts as K8a (K7a).

Only the geometry is saved (the maps are linear).  The three ops are each
other's transposes, so every backward differentiates again: K8b's VJP
(``lane_adjoint``) has K8b as its VJP, and K8a's VJP (K8b's fold
instance) has K8a.  A filter tensor that requires grad raises on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import _kernels
from ._library import NAMESPACE, autograd, call, flatten_batch, flatten_list, split_batch
from ._pallas2 import _on_cpu, dwt_axis_plain, idwt_axis_plain

__all__ = [
    "FLAT_MIN_LANES",
    "MAX_FUSED_DEPTH",
    "PADDED_MODES",
    "analysis_pyramid",
    "flat_multi_depth",
    "flat_multi_syn_depth",
    "flat_wavedec_lane_multi",
    "flat_waverec_lane_multi",
    "multi_analysis_plain",
    "multi_synthesis_plain",
    "sameshift_analysis",
    "sameshift_analysis_plain",
    "synthesis_pyramid",
]

#: A last axis longer than this takes the K7/K8 kernels (the TPU's floor).
FLAT_MIN_LANES = 1 << 16
#: Deepest fused run of levels (the TPU's depth).
MAX_FUSED_DEPTH = 4
#: The pywt padding modes, each level extended by its own band.
PADDED_MODES = ("zero", "reflect", "periodic", "symmetric", "constant")
_MODE_CODE = {mode: code for code, mode in enumerate(PADDED_MODES)}

#: Longest filter the kernels take (``PTWT_MAX_TAPS`` in ``csrc/common.cuh``).
MAX_TAPS = 128
#: Level-0 samples of one tile: an analysis tile owns ``4096 >> D`` level-D
#: outputs, a synthesis tile 4096 final outputs (each halved while the
#: tile's buffers outgrow a block's shared memory).  A card sweep of 2048,
#: 4096 and 8192 (``PERF.md`` §6, PR 7) found 4096 within 5% of the best
#: for every instance.
_TILE_SAMPLES = 4096
#: Shared memory one block may use on the H100 (bytes).
_SMEM_LIMIT = 232448


def _long_lane(n: int, filt_len: int) -> bool:
    """The K7/K8 length gate: a long axis and a filter the kernels hold.

    The kernels' edge blocks size their strips for an even-length bank;
    an odd bank declines to the per-level K3/K4 route."""
    return n > FLAT_MIN_LANES and filt_len % 2 == 0 and 2 <= filt_len <= MAX_TAPS


# ---------------------------------------------------------------------------
# static bookkeeping
# ---------------------------------------------------------------------------


def _std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


def _interior_ranges(n: int, filt_len: int, depth: int):
    """Per level: ``(m_l, W_l, W_r)`` of the padded-mode pyramid.

    ``m_l`` is the band length (each level pads ``padl = (2L-3)//2`` left
    and ``padl + m % 2`` right); ``W_l``/``W_r`` count the positions at
    each end whose values differ from the plain correlation of the raw
    signal, because some tap of their cone reads a mode extension.
    Returns ``(ms, spans)`` with ``ms[0] = n``.
    """
    padl = _std_pad(filt_len)
    ms = [n]
    lv, rv = 0, n - 1
    spans = []
    for _ in range(depth):
        m_prev = ms[-1]
        m = (m_prev + 2 * padl + m_prev % 2 - filt_len) // 2 + 1
        ms.append(m)
        lv = -(-(lv + padl) // 2)
        rv = (rv - (filt_len - 1) + padl) // 2
        spans.append((m, lv, max(0, m - 1 - rv)))
    return tuple(ms), tuple(spans)


def _band_lengths(n: int, filt_len: int, depth: int, mode: str) -> tuple[int, ...]:
    if mode == "periodization":  # an exactly halving chain (K6)
        return tuple(n >> lvl for lvl in range(depth + 1))
    if mode == "valid":
        ms = [n]
        for _ in range(depth):
            ms.append((ms[-1] - filt_len) // 2 + 1)
        return tuple(ms)
    return _interior_ranges(n, filt_len, depth)[0]


def _round4(count: int) -> int:
    return (count + 3) & ~3


def _split_half(count: int) -> int:
    """Elements of one parity half of a staged analysis cone
    (``split_half`` of ``csrc/fwt1d.cu``)."""
    return _round4((count + 1) // 2 + 16)


def _check_taps(depth: int, filt_len: int) -> None:
    if not 1 <= depth <= MAX_FUSED_DEPTH:
        raise ValueError(f"fused depth {depth} is outside 1..{MAX_FUSED_DEPTH}")
    if not 2 <= filt_len <= MAX_TAPS:
        raise ValueError(f"the 1d pyramid kernels take 2..{MAX_TAPS} taps, got {filt_len}")


def _analysis_ints(ms, pads, filt_len: int, itemsize: int, head: Sequence[int], edge_elems: int = 0, wl=None, wr=None):
    """``AnalysisPlan`` ints and shared-memory bytes for band lengths ``ms``
    (``ms[0]`` the input) and per-level offsets ``pads`` (levels 1..D).

    A tile owns ``T`` level-D outputs and ``T 2^(D-l)`` at level l; the
    tiles cover every level.  ``T`` starts at ``_TILE_SAMPLES >> D`` and
    halves until the split cones and the output buffer (or ``edge_elems``,
    the edge block's strips) fit a block's shared memory.  ``head`` is ``[padl, mode,
    strip, edge]`` of the plan.
    """
    depth = len(ms) - 1
    tile = max(1, min(_TILE_SAMPLES >> depth, ms[depth]))
    while True:
        cone0 = (tile << depth) + (filt_len - 2) * ((1 << depth) - 1)
        cone1 = (tile << (depth - 1)) + (filt_len - 2) * ((1 << (depth - 1)) - 1)
        outs = _round4(max(cone1, 2 * _round4(tile)))
        split = 2 * _split_half(cone0) + (2 * _split_half(cone1) if depth > 1 else 0) + outs
        smem = max(split, edge_elems) * itemsize
        if smem <= _SMEM_LIMIT or tile == 1:
            break
        tile //= 2
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the analysis tile needs {smem} bytes of shared memory")
    tiles = max(-(-ms[lvl] // (tile << (depth - lvl))) for lvl in range(1, depth + 1))
    fill = [0] * (MAX_FUSED_DEPTH - depth)
    wl = wl or [0] * (MAX_FUSED_DEPTH + 1)
    wr = wr or [0] * (MAX_FUSED_DEPTH + 1)
    padl, mode, strip, edge = head
    ints = [depth, ms[0], padl, tile, tiles, mode, strip, edge]
    ints += [*ms, *fill] + list(wl) + list(wr) + [0, *pads, *fill]
    return ints, smem


def _multi_plan(n: int, filt_len: int, depth: int, mode: str, itemsize: int):
    """Launch plan of the analysis pyramid kernel: ``(ints, smem_bytes)``.

    ``ints`` is ``AnalysisPlan`` of ``csrc/fwt1d.cu`` in field order:
    ``depth, n, padl, tile, tiles, mode, strip, edge, m[5], wl[5], wr[5],
    pad[5]``.

    Index arithmetic: tile ``t`` owns level-D outputs ``[t T, (t+1) T)``;
    its cone at level ``l - 1`` starts at ``s_{l-1} = 2 s_l - pad_l`` and
    holds ``c_{l-1} = 2 c_l + L - 2`` samples, so
    ``band_l[s_l + j] = sum_k f[k] cone_{l-1}[2 j + k]``.  With tiles
    aligned at level D every read bias (the JAX plan's ``b_l``) is 0, and
    the tile owns ``[t T 2^(D-l), (t+1) T 2^(D-l))`` at level l: every
    band position once.  ``pad_l`` is ``(2L-3)//2`` for the padded modes,
    ``L//2 - 1`` for periodization (read modulo ``n``, no edges) and 0 for
    ``valid`` (no edges).

    The edge block keeps ``E_l = strip << (D - l)`` head and tail samples
    per level; ``strip`` covers every level's edge count and the reach of
    each level's extension (``padl + 2``), so every index a level reads
    lands in one strip of the level below.  Raises ``ValueError`` for what
    the kernel cannot hold.
    """
    _check_taps(depth, filt_len)
    edge = mode in PADDED_MODES
    if mode == "periodization":
        padl = filt_len // 2 - 1
    elif edge:
        padl = _std_pad(filt_len)
    elif mode == "valid":
        padl = 0
    else:
        raise ValueError(f"mode {mode!r} is not a mode of the 1d pyramid kernels")
    ms = _band_lengths(n, filt_len, depth, mode)
    if ms[depth] < 1:
        raise ValueError(f"a {n}-sample signal has no level {depth}")
    wl = [0] * (MAX_FUSED_DEPTH + 1)
    wr = [0] * (MAX_FUSED_DEPTH + 1)
    strip = 0
    if edge:
        strip = padl + 2
        for lvl, (_, w_l, w_r) in enumerate(_interior_ranges(n, filt_len, depth)[1], 1):
            wl[lvl], wr[lvl] = w_l, w_r
            strip = max(strip, -(-max(w_l, w_r) >> (depth - lvl)))
        if any(strip << (depth - lvl) > ms[lvl] for lvl in range(depth + 1)):
            raise ValueError(
                f"a {n}-sample signal is shorter than the edge strips of a "
                f"depth-{depth} run of {filt_len} taps"
            )
    head = [padl, _MODE_CODE.get(mode, 0), strip, int(edge)]
    return _analysis_ints(ms, [padl] * depth, filt_len, itemsize, head, 3 * (strip << depth), wl, wr)


def _adjoint_plan(filt_len: int, out_len: int, lens: Sequence[int], offs: Sequence[int], itemsize: int):
    """Plan of the analysis pyramid kernel with per-level offsets and no
    edge block: ``(ints, smem_bytes)``.  Level l (band of ``lens[l-1]``
    samples) reads level l - 1 from ``2i - offs[l-1]``, zero outside it,
    starting from the ``out_len``-sample input.

    Two instances: the VJP of a fused synthesis run (K8b's, K7b's; the
    transpose of step l is one analysis level with the rec taps and
    ``pad_l = offs[l-1]``), and the *sameshift* instance, the interiors of
    a boundary-wavelet long run (the dec taps, an exactly halving chain,
    every offset the ``sameshift`` offset ``a``).
    """
    depth = len(lens)
    _check_taps(depth, filt_len)
    return _analysis_ints([out_len, *lens], list(offs), filt_len, itemsize, [0, 0, 0, 0])


def _fold_strips(filt_len: int, lens: Sequence[int], pad: int) -> tuple[int, list[int]]:
    """The edge block of K8a's VJP: ``(wz, strips)``.

    Positions within ``Z_{l-1} = 2 Z_l + L + 1`` (``Z_D = 0``) of either
    end of level ``l - 1`` differ from the plain synthesis chain: the fold
    of pywt's extension reaches ``pad + 2`` positions, and the reads of
    ``Z_l`` wrong band positions reach ``2 Z_l + L - 1 - pad`` more.  The
    edge block writes the first and last ``wz = Z_0`` outputs and keeps
    ``E_l`` head and tail positions of each level, ``E_0 = wz`` and
    ``E_l = (E_{l-1} + pad + 1) // 2 + 2``, each at most its band: so every
    band position a step reads lies in a strip, and every fold target too.
    """
    z = 0
    for _ in lens[1:]:
        z = 2 * z + filt_len + 1
    strips = [min(z, lens[0])]
    for m in lens[1:]:
        strips.append(min(m, (strips[-1] + pad + 1) // 2 + 2))
    return strips[0], strips


def _syn_tile_elems(tile: int, filt_len: int, depth: int) -> int:
    """Elements of a synthesis tile's band buffers (``synthesis_tile_elems``
    of ``csrc/fwt1d.cu``): every hi band and lo_D over their range bounds
    ``span_l = (span_{l-1} + L - 1) // 2 + 1`` (``span_0 = T``), and two
    buffers for the intermediate lo bands."""
    spans = [tile]
    for _ in range(depth):
        spans.append((spans[-1] + filt_len - 1) // 2 + 1)
    return sum(spans[1:]) + spans[depth] + sum(spans[1 : min(depth, 3)])


def _syn_plan(
    filt_len: int,
    out_len: int,
    lens: Sequence[int],
    offs: Sequence[int],
    itemsize: int,
    fold: Optional[str] = None,
):
    """Launch plan of the synthesis pyramid kernel: ``(ints, smem_bytes)``.

    ``ints`` is ``SynthesisPlan`` of ``csrc/fwt1d.cu``: ``depth, tile,
    tiles, buf, len[5], off[5], mode, edge, wz, ebuf, strip[5]``;
    ``lens[l-1]``/``offs[l-1]`` are band l's length and step l's left crop,
    fine to coarse.  A tile owns final outputs ``[c_0, c_0 + T)``; step l
    reads its bands over ``c_l = floor((c_{l-1} + off_l - (L-1)) / 2)`` to
    ``e_l = floor((e_{l-1} + off_l) / 2)``, so the read bias of the JAX
    plan, ``(c_{l-1} + off_l - (L-1)) - 2 c_l`` in {0, 1}, is the floor's
    remainder.  Every band is staged at once, so ``buf`` holds all of a
    tile's band ranges (:func:`_syn_tile_elems`); ``T`` starts at
    ``_TILE_SAMPLES`` and halves until they fit.

    ``fold`` (a padded mode) makes the launch K8a's VJP: every ``offs`` is
    the analysis ``padl``, and one edge block per row folds pywt's
    extension back (:func:`_fold_strips`).
    """
    depth = len(lens)
    _check_taps(depth, filt_len)
    tile = max(1, min(_TILE_SAMPLES, out_len))
    while True:
        buf = _syn_tile_elems(tile, filt_len, depth)
        if buf * itemsize <= _SMEM_LIMIT or tile == 1:
            break
        tile //= 2
    tiles = -(-out_len // tile)
    smem = buf * itemsize
    fill = [0] * (MAX_FUSED_DEPTH - depth)
    tail = [0, 0, 0, 0] + [0] * (MAX_FUSED_DEPTH + 1)
    if fold is not None:
        wz, strips = _fold_strips(filt_len, [out_len, *lens], offs[0])
        ebuf = 2 * max(strips)
        ext = 2 * offs[0] + 2
        smem = max(smem, (3 * ebuf + ext) * itemsize + 4 * ext)
        tail = [_MODE_CODE[fold], 1, wz, ebuf, *strips, *fill]
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the synthesis tile needs {smem} bytes of shared memory")
    ints = [depth, tile, tiles, buf, out_len, *lens, *fill, 0, *offs, *fill] + tail
    return ints, smem


# ---------------------------------------------------------------------------
# launch glue shared by K6, K7 and K8
# ---------------------------------------------------------------------------


def _launch_analysis(kernel, x2, lo, hi, ints, smem, circular, out):
    """Launch the analysis pyramid kernel on ``x2 = [rows, n]`` with a plan;
    returns ``(lo_D, [hi_1, ..., hi_D])``, written into ``out`` if given."""
    _kernels.check_tensor("x", x2, x2.dtype, x2.device)
    rows = x2.shape[0]
    depth = ints[0]
    ms = ints[8 : 9 + depth]
    if out is None:
        out = [x2.new_empty(rows, ms[depth])] + [x2.new_empty(rows, m) for m in ms[1:]]
    for t, m in zip(out, [ms[depth], *ms[1:]]):
        _kernels.check_tensor("band", t, x2.dtype, x2.device)
        if t.numel() != rows * m:
            raise ValueError(f"an output band holds {t.numel()} values, expected {rows * m}")
    if rows:
        his = list(out[1:]) + [None] * (MAX_FUSED_DEPTH - depth)
        _kernels.launch(
            kernel, "ptwt_fwt1d_analysis", x2.device, x2.dtype,
            x2, out[0], *his, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            rows, _kernels.int_array(ints), int(circular), smem,
        )
    return out[0], list(out[1:])


def analysis_pyramid(
    kernel: str,
    x2: torch.Tensor,
    lo,
    hi,
    depth: int,
    mode: str,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Launch the analysis pyramid kernel on ``x2 = [rows, n]``.

    ``lo``/``hi`` are the flipped taps as floats.  Returns ``(lo_D,
    [hi_1, ..., hi_D])``, each ``[rows, m_l]``; ``out`` may give them as
    ``(lo_D, hi_1, ..., hi_D)`` contiguous tensors to write into.  The
    launch counts as ``kernel``.
    """
    ints, smem = _multi_plan(x2.shape[-1], len(lo), depth, mode, x2.element_size())
    return _launch_analysis(kernel, x2, lo, hi, ints, smem, mode == "periodization", out)


def synthesis_pyramid(
    kernel: str,
    bands: Sequence[torch.Tensor],
    lo,
    hi,
    offs: Sequence[int],
    out_len: int,
    circular: bool,
    fold: Optional[str] = None,
) -> torch.Tensor:
    """Launch the synthesis pyramid kernel.

    ``bands = [lo_D, hi_D, ..., hi_1]``, each ``[rows, m_l]``, with
    ``lo_D`` as long as ``hi_D``; ``offs`` are the left crops of steps
    ``1..D`` (fine to coarse); step 1 writes ``out_len`` samples.
    Padded-mode runs need every ``hi_l`` (``l < D``) as long as step
    ``l + 1``'s output, which is what the crops make of it.  ``fold`` (a
    padded mode) runs K8a's VJP: the edge block folds that mode's
    extension back.  Returns ``[rows, out_len]``; the launch counts as
    ``kernel``.
    """
    ref = bands[0]
    rows = ref.shape[0]
    depth = len(bands) - 1
    for t in bands:
        _kernels.check_tensor("band", t, ref.dtype, ref.device)
    if bands[0].shape != bands[1].shape:
        raise ValueError(
            f"lo and hi of the coarsest step differ: {tuple(bands[0].shape)} and {tuple(bands[1].shape)}"
        )
    lens = [bands[depth + 1 - lvl].shape[-1] for lvl in range(1, depth + 1)]
    ints, smem = _syn_plan(len(lo), out_len, lens, offs, ref.element_size(), fold)
    out = ref.new_empty(rows, out_len)
    if out.numel():
        his = [bands[depth + 1 - lvl] for lvl in range(1, depth + 1)]
        his += [None] * (MAX_FUSED_DEPTH - depth)
        _kernels.launch(
            kernel, "ptwt_fwt1d_synthesis", ref.device, ref.dtype,
            bands[0], *his, out, _kernels.taps_array(lo), _kernels.taps_array(hi), len(lo),
            rows, _kernels.int_array(ints), int(circular), smem,
        )
    return out


#: The kernel a VJP launch counts as: each pyramid kernel carries the VJP
#: of the other's fused runs.
_VJP_KERNEL = {"K8a": "K8b", "K7a": "K7b", "K8b": "K8a", "K7b": "K7a"}


# K8a (K7a at depth 1): a fused run of analysis levels on [rows, n]


@torch.library.custom_op(f"{NAMESPACE}::lane_analysis", mutates_args=())
def lane_analysis(
    x2: torch.Tensor, kernel: str, lo: list[float], hi: list[float], depth: int, mode: str
) -> list[torch.Tensor]:
    """K8a (``kernel`` K7a at depth 1) on ``[rows, n]``: ``[packed_D, hi_1,
    ..., hi_{D-1}]`` with ``packed_D = [2, rows, m_D]`` holding (lo_D,
    hi_D)."""
    rows, n = x2.shape
    ms = _band_lengths(n, len(lo), depth, mode)
    packed = x2.new_empty(2, rows, max(ms[depth], 0))
    his = [x2.new_empty(rows, m) for m in ms[1:depth]]
    analysis_pyramid(kernel, x2, lo, hi, depth, mode, out=(packed[0], *his, packed[1]))
    return [packed, *his]


@lane_analysis.register_fake
def _(x2, kernel, lo, hi, depth, mode):
    rows, n = x2.shape
    ms = _band_lengths(n, len(lo), depth, mode)
    return [x2.new_empty(2, rows, max(ms[depth], 0))] + [x2.new_empty(rows, m) for m in ms[1:depth]]


def _lane_analysis_setup(ctx, inputs, output):
    x2, kernel, lo, hi, depth, mode = inputs
    ctx.plan = (kernel, x2.shape[-1], lo, hi, mode)


def _lane_analysis_backward(ctx, cts):
    """One launch of the synthesis pyramid kernel with the same (flipped
    dec) taps, crops ``padl`` and the mode's extension folded back
    (counted as K8b, K7b at depth 1)."""
    kernel, n, lo, hi, mode = ctx.plan
    ct, *ct_his = cts
    ct = ct.contiguous()
    bands = [ct[0], ct[1], *(c.contiguous() for c in ct_his[::-1])]
    pad = 0 if mode == "valid" else _std_pad(len(lo))
    fold = mode if mode in PADDED_MODES else None
    grad = call(lane_synthesis, bands, _VJP_KERNEL[kernel], lo, hi, [pad] * (len(ct_his) + 1), n, fold)
    return (grad,) + (None,) * 5


@lane_analysis.register_vmap
def _(info, in_dims, x2, kernel, lo, hi, depth, mode):
    size = info.batch_size
    packed, *his = lane_analysis(flatten_batch(x2, in_dims[0], size), kernel, lo, hi, depth, mode)
    return [split_batch(packed, size, 1)] + [split_batch(h, size) for h in his], [1] + [0] * len(his)


# K8b (K7b at depth 1): a fused run of synthesis steps (also K8a's VJP, the
# fold instance)


@torch.library.custom_op(f"{NAMESPACE}::lane_synthesis", mutates_args=())
def lane_synthesis(
    bands: list[torch.Tensor],
    kernel: str,
    lo: list[float],
    hi: list[float],
    offs: list[int],
    out_len: int,
    fold: Optional[str],
) -> torch.Tensor:
    """K8b (``kernel`` K7b at depth 1) on ``[lo_D, hi_D, ..., hi_1]`` ->
    ``[rows, out_len]`` (:func:`synthesis_pyramid`; ``fold`` makes it K8a's
    VJP)."""
    return synthesis_pyramid(kernel, bands, lo, hi, offs, out_len, False, fold)


@lane_synthesis.register_fake
def _(bands, kernel, lo, hi, offs, out_len, fold):
    return bands[0].new_empty(bands[0].shape[0], out_len)


def _lane_synthesis_setup(ctx, inputs, output):
    bands, kernel, lo, hi, offs, out_len, fold = inputs
    depth = len(bands) - 1
    lens = [bands[depth + 1 - lvl].shape[-1] for lvl in range(1, depth + 1)]
    ctx.plan = (kernel, lo, hi, offs, lens, fold)


def _lane_synthesis_backward(ctx, ct):
    """One launch of the analysis pyramid kernel with the same taps
    (counted as K8a, K7a at depth 1): for K8b, each level offset by its
    step's crop and zero outside its band (``lane_adjoint``); for the fold
    instance (K8a's VJP, the flipped dec taps), K8a itself with the mode
    it folded."""
    kernel, lo, hi, offs, lens, fold = ctx.plan
    ct = ct.contiguous()
    if fold is not None:
        packed, *his = call(lane_analysis, ct, _VJP_KERNEL[kernel], lo, hi, len(lens), fold)
        return ([packed[0], packed[1], *his[::-1]],) + (None,) * 6
    lo_band, *his = call(lane_adjoint, ct, _VJP_KERNEL[kernel], lo, hi, offs, lens)
    return ([lo_band, *his[::-1]],) + (None,) * 6


@lane_synthesis.register_vmap
def _(info, in_dims, bands, kernel, lo, hi, offs, out_len, fold):
    size = info.batch_size
    out = lane_synthesis(flatten_list(bands, in_dims[0], size), kernel, lo, hi, offs, out_len, fold)
    return split_batch(out, size), 0


# K8b's VJP: the analysis pyramid kernel on the adjoint plan


@torch.library.custom_op(f"{NAMESPACE}::lane_adjoint", mutates_args=())
def lane_adjoint(
    ct: torch.Tensor, kernel: str, lo: list[float], hi: list[float], offs: list[int], lens: list[int]
) -> list[torch.Tensor]:
    """The analysis pyramid kernel on ``[rows, n]`` with per-level offsets
    ``offs``, zero outside each band of ``lens`` (:func:`_adjoint_plan`):
    ``[lo_D, hi_1, ..., hi_D]``."""
    ints, smem = _adjoint_plan(len(lo), ct.shape[-1], lens, offs, ct.element_size())
    lo_band, his = _launch_analysis(kernel, ct, lo, hi, ints, smem, False, None)
    return [lo_band, *his]


@lane_adjoint.register_fake
def _(ct, kernel, lo, hi, offs, lens):
    rows = ct.shape[0]
    return [ct.new_empty(rows, lens[-1])] + [ct.new_empty(rows, m) for m in lens]


@lane_adjoint.register_vmap
def _(info, in_dims, ct, kernel, lo, hi, offs, lens):
    size = info.batch_size
    outs = lane_adjoint(flatten_batch(ct, in_dims[0], size), kernel, lo, hi, offs, lens)
    return [split_batch(t, size) for t in outs], [0] * len(outs)


def _lane_adjoint_setup(ctx, inputs, output):
    ct, kernel, lo, hi, offs, lens = inputs
    ctx.plan = (kernel, lo, hi, offs, ct.shape[-1])


def _lane_adjoint_backward(ctx, cts):
    """K8b itself (K7b at depth 1): the synthesis pyramid on the same
    offsets with no fold, of which this op is the transpose."""
    kernel, lo, hi, offs, n = ctx.plan
    lo_ct, *his_cts = cts
    bands = [lo_ct.contiguous(), *(c.contiguous() for c in his_cts[::-1])]
    grad = call(lane_synthesis, bands, _VJP_KERNEL[kernel], lo, hi, offs, n, None)
    return (grad,) + (None,) * 5


autograd(lane_analysis, _lane_analysis_setup, _lane_analysis_backward)
autograd(lane_synthesis, _lane_synthesis_setup, _lane_synthesis_backward)
autograd(lane_adjoint, _lane_adjoint_setup, _lane_adjoint_backward)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def multi_analysis_plain(
    x: torch.Tensor, dec_lo, dec_hi, mode: str, depth: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``depth`` levels of :func:`dwt_axis_plain` on the last axis:
    ``(lo_depth, [hi_1, ..., hi_depth])``."""
    his = []
    cur = x
    for _ in range(depth):
        cur, h = dwt_axis_plain(cur, -1, dec_lo, dec_hi, mode)
        his.append(h)
    return cur, his


def sameshift_analysis_plain(
    x: torch.Tensor, dec_lo, dec_hi, pad: int, depth: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The plain version of K8a's sameshift instance: ``depth`` levels of
    :func:`dwt_axis_plain` in ``valid`` on each band zero-padded by
    ``pad`` and ``L - 2 - pad``, so level ``l`` has half the samples of
    level ``l - 1``.  ``(lo_depth, [hi_1, ..., hi_depth])``."""
    filt_len = len(dec_lo)
    his = []
    cur = x
    for _ in range(depth):
        padded = torch.nn.functional.pad(cur, (pad, filt_len - 2 - pad))
        cur, h = dwt_axis_plain(padded, -1, dec_lo, dec_hi, "valid")
        his.append(h)
    return cur, his


def multi_synthesis_plain(coeffs, rec_lo, rec_hi, pads, lens) -> torch.Tensor:
    """``depth`` steps of :func:`idwt_axis_plain` on the last axis, each
    cropped to ``lens`` by ``pads`` (fine to coarse), as the JAX
    package's ``_syn_vjp_for._reference`` computes them."""
    filt_len = len(rec_lo)
    depth = len(coeffs) - 1
    cur = coeffs[0]
    for step in range(depth):
        lvl = depth - step
        hi_band = coeffs[1 + step]
        padl = pads[lvl - 1]
        padr = 2 * (hi_band.shape[-1] - 1) + filt_len - padl - lens[lvl - 1]
        cur = idwt_axis_plain(cur, hi_band, -1, rec_lo, rec_hi, padl, padr, "zero")
    return cur


# ---------------------------------------------------------------------------
# routing and public wrappers
# ---------------------------------------------------------------------------


def flat_multi_depth(n: int, filt_len: int, mode: str, level: int) -> int:
    """Largest fused depth for the first levels of a wavedec (0: none).

    A padded mode on a last axis longer than :data:`FLAT_MIN_LANES`, runs
    of at least 2 and at most :data:`MAX_FUSED_DEPTH` levels.
    """
    if mode not in PADDED_MODES or not _long_lane(n, filt_len):
        return 0
    depth = min(level, MAX_FUSED_DEPTH)
    return depth if depth >= 2 else 0


def flat_multi_syn_depth(out_lens: Sequence[int], filt_len: int, mode: str) -> int:
    """Largest fused suffix depth for a waverec chain (0: none).

    ``out_lens`` are the per-step output lengths, coarse to fine; the
    fused run covers the last (long) steps.  Mirrors
    :func:`flat_multi_depth`: any crops fit the kernel's plan.
    """
    if mode not in PADDED_MODES or not out_lens or not _long_lane(out_lens[-1], filt_len):
        return 0
    depth = min(len(out_lens), MAX_FUSED_DEPTH)
    return depth if depth >= 2 else 0


def flat_wavedec_lane_multi(
    x: torch.Tensor, dec_lo, dec_hi, mode: str, depth: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """First ``depth`` analysis levels along the last axis, fused.

    Returns ``(lo_depth, [hi_1, ..., hi_depth])`` with ``x``'s leading
    axes; the values are those of the per-level padded transform.
    ``dec_lo``/``dec_hi`` are flipped (correlation order).  A CPU tensor
    runs :func:`multi_analysis_plain`; a CUDA tensor runs K8a (counted as
    K7a at depth 1).
    """
    if _on_cpu(x):
        return multi_analysis_plain(x, dec_lo, dec_hi, mode, depth)
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), x.shape[-1]).contiguous()
    kernel = "K8a" if depth > 1 else "K7a"
    packed, *his = call(lane_analysis, x2, kernel, lo, hi, depth, mode)
    lo_band, hi_band = packed.unbind(0)
    # explicit lengths: an empty batch leaves no -1 to infer
    return lo_band.reshape(*lead, lo_band.shape[-1]), [h.reshape(*lead, h.shape[-1]) for h in (*his, hi_band)]


def sameshift_analysis(
    x2: torch.Tensor, dec_lo, dec_hi, pad: int, depth: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The interiors of a boundary-wavelet long run on ``x2 = [rows, n]``:
    ``(lo_depth, [hi_1, ..., hi_depth])`` as :func:`sameshift_analysis_plain`
    computes them.  ``dec_lo``/``dec_hi`` are flipped.  A CPU tensor runs
    the plain version; a CUDA tensor one launch of K8a's sameshift
    instance (:func:`_adjoint_plan`).  No op of its own: the run that
    calls it differentiates its whole map
    (:class:`~._boundary_long.LongAnalysisRun`)."""
    if _on_cpu(x2):
        return sameshift_analysis_plain(x2, dec_lo, dec_hi, pad, depth)
    lo = _kernels.static_taps(dec_lo)
    hi = _kernels.static_taps(dec_hi)
    x2 = x2.contiguous()
    n = x2.shape[-1]
    ints, smem = _adjoint_plan(len(lo), n, [n >> lvl for lvl in range(1, depth + 1)], [pad] * depth, x2.element_size())
    return _launch_analysis("K8a", x2, lo, hi, ints, smem, False, None)


def flat_waverec_lane_multi(coeffs, rec_lo, rec_hi, pads, lens) -> torch.Tensor:
    """Fused suffix of a waverec chain along the last axis.

    ``coeffs = [lo_D, hi_D, ..., hi_1]`` with any leading axes;
    ``pads``/``lens`` are the per-step left crops and output lengths, fine
    to coarse (``pads[0]``/``lens[0]`` belong to the finest step).  The
    values are those of the per-step padded synthesis.  A CPU tensor runs
    :func:`multi_synthesis_plain`; a CUDA tensor runs K8b (counted as K7b
    at depth 1).
    """
    if _on_cpu(coeffs[0]):
        return multi_synthesis_plain(coeffs, rec_lo, rec_hi, pads, lens)
    lo = _kernels.static_taps(rec_lo)
    hi = _kernels.static_taps(rec_hi)
    depth = len(coeffs) - 1
    for lvl in range(1, depth):
        if coeffs[depth + 1 - lvl].shape[-1] != lens[lvl]:
            raise ValueError(
                f"band {lvl} has {coeffs[depth + 1 - lvl].shape[-1]} samples, "
                f"step {lvl + 1} makes {lens[lvl]}"
            )
    lead = coeffs[0].shape[:-1]
    rows = math.prod(lead)
    bands = [c.reshape(rows, c.shape[-1]).contiguous() for c in coeffs]
    kernel = "K8b" if depth > 1 else "K7b"
    out = call(lane_synthesis, bands, kernel, lo, hi, list(pads)[:depth], lens[0], None)
    return out.reshape(*lead, lens[0])
