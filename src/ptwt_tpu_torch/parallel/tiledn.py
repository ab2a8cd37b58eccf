"""Tiled multi-device 1d and 3d FWT: ring halo exchange over sharded axes.

Counterpart of :mod:`ptwt_tpu.parallel.tiledn`.  The *first* transformed
axis is sharded over the mesh's ``spatial`` axis (``tiled_wavedec2``'s chip
grid also shards the last one over ``spatial_w``); the batch over ``data``
(or ``host`` and ``data`` jointly); every other transformed axis stays
local.  ``periodization``'s circular topology maps onto a ring: each level
exchanges ``filt_len // 2 - 1`` halo rows with the ring neighbours
(:mod:`._ring`), and the outputs are the serial ``wavedec(...)`` /
``wavedec3(...)`` with ``mode="periodization"``.  The padded pywt modes run
the capacity-chunked levels of :mod:`._padded_axis`.

Where JAX runs the body under ``shard_map``, each process here runs it on
its own chunk: the rank's coordinates are read on the host
(``mesh.get_local_rank``), so every offset is a Python int.  Inputs are a
``DTensor`` laid out as below or the whole tensor on every rank (each rank
keeps its chunk, ``torch.chunk``'s split, as ``distribute_tensor`` would);
the coefficients come back as ``DTensor``s with ``Shard`` placements whose
``full_tensor()`` gathers the serial transform's bands.

Each local level goes through :func:`~ptwt_tpu_torch.ops._dispatch.dwt_axis_packed` /
:func:`~ptwt_tpu_torch.ops._dispatch.idwt_axis_pairs`: K3/K4 on the card (K7a/K7b on a
local last axis longer than ``2**16`` samples in a padded mode), their
plain versions on the CPU.  A local ``periodization`` axis runs K3/K4 in
that mode, which read modulo the axis and fold the overhang in their index
range, where the JAX package wrap-pads and crops with copies; an axis
whose mesh axis holds one rank is local too (its ring would be the
identity).

The overlapped ring level (:func:`_dwt_axis_ring`) posts the halo ring
steps (:func:`~._ring.start_exchange`), launches the interior windows,
which need no halo, then waits and runs the two thin edge strips;
``PTWT_TPU_NO_OVERLAP=1`` selects the pad-then-compute schedule.  Both
give the same numbers, and gradients flow through both: the posting is a
functional collective whose backward is the opposite ring step, the wait
its ``wait_tensor``, and the levels between them the ordinary K3/K4 ops.

Every entry point runs under ``torch.compile(fullgraph=True)`` as one
graph, as the JAX package's runs under ``jax.jit``: the ring steps and
edge sums are functional collectives in the graph (the wait where the
eager schedule waits), the banks host constants
(:func:`~ptwt_tpu_torch.utils._preprocess.filter_taps`), and the
geometry python ints and cached host arrays, so no branch reads a tensor.
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..constants import Wavelet, WaveletCoeff1d, WaveletCoeffNd
from ..conv_transform import _adjust_padding_at_reconstruction, _check_dtype
from ..conv_transform_3 import _DETAIL_KEYS
from ..ops._dispatch import dwt_axis_packed, idwt_axis_pairs
from ..utils import SUBBAND_ORDERS, filter_taps
from ..utils._preprocess import host_constant
from ._padded_axis import (
    _with_zeros,
    padded_level_geometry,
    sharded_dwt_level,
    sharded_idwt_level,
)
from ._ring import BWD, FWD, axis_size, exchange, start_exchange

__all__ = [
    "tiled_wavedec",
    "tiled_waverec",
    "tiled_wavedec3",
    "tiled_waverec3",
]


# ---------------------------------------------------------------------------
# layout: local chunks in, DTensors out
# ---------------------------------------------------------------------------


def _mesh_batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dim shards over (host outermost when present)."""
    return ("host", "data") if "host" in mesh.mesh_dim_names else ("data",)


def _layout(mesh, *spatial) -> dict[str, int]:
    """Tensor dim of each mesh axis that shards one: the batch (dim 0) over
    the batch axes, then ``spatial`` pairs ``(mesh axis, dim)``."""
    dims = {name: 0 for name in _mesh_batch_axes(mesh)}
    dims.update({name: dim for name, dim in spatial if name is not None})
    return dims


def _placements(mesh, dims: dict[str, int]) -> list:
    return [Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names]


def _chunk(size: int, parts: int, index: int) -> tuple[int, int]:
    """``(start, length)`` of chunk ``index`` of ``torch.chunk``'s split."""
    full = -(-size // parts)
    start = min(full * index, size)
    return start, min(size, start + full) - start


def _as_input(data) -> torch.Tensor:
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(data)
    _check_dtype(data.dtype)
    return data


def _local(t, mesh, dims: dict[str, int]) -> torch.Tensor:
    """This rank's chunk of ``t`` (a ``DTensor``, redistributed to the
    layout if it has another, or the whole tensor), on the mesh's device."""
    placements = _placements(mesh, dims)
    if isinstance(t, DTensor):
        if t.device_mesh != mesh:
            raise ValueError("the DTensor lives on another device mesh")
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local()
    local = t
    for name in mesh.mesh_dim_names:  # nested chunks, outermost mesh axis first
        if name in dims:
            start, length = _chunk(local.shape[dims[name]], axis_size(mesh, name), mesh.get_local_rank(name))
            local = local.narrow(dims[name], start, length)
    return local.to(mesh.device_type)


def _pad_to_capacity(x: torch.Tensor, cap: int, axis: int) -> torch.Tensor:
    """The local chunk zero-padded to the capacity ``cap`` along ``axis``."""
    ax = axis % x.ndim
    return _with_zeros(x, ax, 0, cap - x.shape[ax])


def _global(local: torch.Tensor, mesh, dims: dict[str, int], batch: int, lengths: dict[int, int]) -> DTensor:
    """A ``DTensor`` from this rank's chunk (capacity or exact) of a global
    tensor whose sharded dims have the valid ``lengths``: the chunk is cut
    to its valid rows, ``torch.chunk``'s split of the global length."""
    shape = [batch, *local.shape[1:]]
    for name, dim in dims.items():
        if dim:
            _, valid = _chunk(lengths[dim], axis_size(mesh, name), mesh.get_local_rank(name))
            local = local.narrow(dim, 0, valid)
            shape[dim] = lengths[dim]
    stride, step = [], 1
    for size in reversed(shape):
        stride.append(step)
        step *= size
    return DTensor.from_local(
        local, mesh, _placements(mesh, dims), run_check=False,
        shape=torch.Size(shape), stride=tuple(reversed(stride)),
    )


def _spatial_lengths(local: torch.Tensor, mesh, dims: dict[str, int]) -> dict[int, int]:
    """Global lengths of the evenly sharded dims of a periodization band."""
    return {dim: local.shape[dim] * axis_size(mesh, name) for name, dim in dims.items() if dim}


# ---------------------------------------------------------------------------
# ring levels
# ---------------------------------------------------------------------------


@torch.compiler.assume_constant_result
def _overlap_enabled() -> bool:
    """Halo-compute overlap kill switch (``PTWT_TPU_NO_OVERLAP=1``): read
    at every eager call, and once, at trace time, by ``torch.compile``
    (a compiled transform keeps the schedule it was traced with)."""
    return not os.environ.get("PTWT_TPU_NO_OVERLAP")


def _idwt_pairs(los, his, axis: int, rec_lo, rec_hi, padl: int, padr: int, mode: str) -> torch.Tensor:
    """:func:`~ptwt_tpu_torch.ops._dispatch.idwt_axis_pairs` over any number of (lo, hi)
    pairs, at most two a launch (K4's limit); ``[G, ...]``."""
    outs = [
        idwt_axis_pairs(los[i : i + 2], his[i : i + 2], axis, rec_lo, rec_hi, padl, padr, mode)
        for i in range(0, len(los), 2)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _halo_pad_sharded(x: torch.Tensor, halo: int, ax: int, axis_name: str, mesh) -> torch.Tensor:
    """Pad ``ax`` with the ring neighbours' boundary slabs."""
    n = x.shape[ax]
    top, bottom = exchange([x.narrow(ax, n - halo, halo), x.narrow(ax, 0, halo)], [FWD, BWD], axis_name, mesh)
    return torch.cat([top, x, bottom], dim=ax)


def _ring_crop_sharded(t: torch.Tensor, pad: int, filt_len: int, ax: int, axis_name: str, mesh) -> torch.Tensor:
    """Fold the synthesis overhang across the ring on the sharded axis."""
    target = t.shape[ax] - (filt_len - 2)
    core = t.narrow(ax, pad, target)
    if pad > 0:
        tail = t.narrow(ax, pad + target, t.shape[ax] - pad - target)
        head = t.narrow(ax, 0, pad)
        from_left, from_right = exchange([tail, head], [FWD, BWD], axis_name, mesh)
        core = core.clone()
        core.narrow(ax, 0, pad).add_(from_left)
        core.narrow(ax, target - pad, pad).add_(from_right)
    return core


def _dwt_axis_ring(x: torch.Tensor, axis: int, dec_lo, dec_hi, halo: int, axis_name: str, mesh) -> torch.Tensor:
    """One ``valid`` analysis level along a ring-sharded axis, overlapped;
    packed ``[2, ...]``.

    Numerically equivalent to ``dwt_axis_packed`` over the halo-padded ``x``, but
    scheduled so that the halo P2P is in flight *while* the bulk of the
    stencil runs: the interior windows depend only on local data, so they
    are launched before the wait; two thin edge strips (a handful of
    windows each) consume the arrived halos and are stitched around the
    interior.
    """
    ax = axis % x.ndim
    n = x.shape[ax]
    filt_len = len(dec_lo)
    if halo == 0:
        return dwt_axis_packed(x, ax, dec_lo, dec_hi, "valid")
    b = halo % 2  # interior window phase offset in local coordinates
    i0 = (halo + 1) // 2  # windows touching the top halo
    n_int = (n - b - filt_len) // 2 + 1
    m = (n + 2 * halo - filt_len) // 2 + 1
    s_r = 2 * (i0 + n_int) - halo  # first right-edge window, local coords
    if (
        not _overlap_enabled()
        or n_int < 1
        or s_r < 0
        or 2 * (i0 - 1) + filt_len - halo > n
    ):
        return dwt_axis_packed(_halo_pad_sharded(x, halo, ax, axis_name, mesh), ax, dec_lo, dec_hi, "valid")
    pending = start_exchange(
        [x.narrow(ax, n - halo, halo), x.narrow(ax, 0, halo)], [FWD, BWD], axis_name, mesh
    )
    # interior: windows fully inside x, independent of the exchange
    inner = dwt_axis_packed(x.narrow(ax, b, 2 * (n_int - 1) + filt_len), ax, dec_lo, dec_hi, "valid")
    top, bottom = pending.wait()
    # edges: thin strips built from the arrived halos
    left = torch.cat([top, x.narrow(ax, 0, 2 * (i0 - 1) + filt_len - halo)], dim=ax)
    parts = [dwt_axis_packed(left, ax, dec_lo, dec_hi, "valid"), inner]
    if m - i0 - n_int > 0:
        right = torch.cat([x.narrow(ax, s_r, n - s_r), bottom], dim=ax)
        parts.append(dwt_axis_packed(right, ax, dec_lo, dec_hi, "valid"))
    return torch.cat(parts, dim=ax + 1)


def _idwt_axis_ring(los: Sequence[torch.Tensor], his: Sequence[torch.Tensor], rec_lo, rec_hi, axis: int,
                    axis_name: str, mesh) -> torch.Tensor:
    """One synthesis level along a ring-sharded axis for each (lo, hi)
    pair, overlapped; ``[G, ...]``.

    Equivalent to the local transposed convolution followed by
    :func:`_ring_crop_sharded`, but the cross-shard overhang is resolved
    from *pre-exchanged raw edge-coefficient slabs*: the exchanged slabs
    are plain input slices, so the P2P is in flight during the main
    synthesis; each rank then recomputes its neighbours' tiny overhang
    strips locally (a few columns of transposed convolution) and folds
    them into its core.
    """
    ax = axis % los[0].ndim
    fax = ax + 1
    m = los[0].shape[ax]
    filt_len = len(rec_lo)
    pad = filt_len // 2 - 1
    g = len(los)
    if pad == 0:  # haar: the transposed conv never crosses shards
        return _idwt_pairs(los, his, ax, rec_lo, rec_hi, 0, 0, "zero")
    # trailing/leading coefficient columns feeding the overhangs
    c_t = m - -(-(2 * m + pad - filt_len + 1) // 2)
    c_h = (pad - 1) // 2 + 1
    if not _overlap_enabled() or c_t < 1 or c_t > m or c_h > m:
        full = _idwt_pairs(los, his, ax, rec_lo, rec_hi, 0, 0, "zero")
        return _ring_crop_sharded(full, pad, filt_len, fax, axis_name, mesh)
    bands = [*los, *his]
    # raw slabs in flight before any compute: every pair's lo then hi
    pending = start_exchange(
        [torch.stack([t.narrow(ax, m - c_t, c_t) for t in bands]), torch.stack([t.narrow(ax, 0, c_h) for t in bands])],
        [FWD, BWD], axis_name, mesh,
    )
    full = _idwt_pairs(los, his, ax, rec_lo, rec_hi, 0, 0, "zero")
    target = 2 * m
    core = full.narrow(fax, pad, target).clone()
    left_tails, right_heads = pending.wait()
    # left neighbour's tail overhang: tail of its last-c_t-column strip
    strip_l = _idwt_pairs(left_tails[:g].unbind(0), left_tails[g:].unbind(0), ax, rec_lo, rec_hi, 0, 0, "zero")
    tail = strip_l.narrow(fax, pad + 2 * c_t, filt_len - 2 - pad)
    core.narrow(fax, 0, tail.shape[fax]).add_(tail)
    # right neighbour's head overhang: head of its first-c_h-column strip
    strip_r = _idwt_pairs(right_heads[:g].unbind(0), right_heads[g:].unbind(0), ax, rec_lo, rec_hi, 0, 0, "zero")
    core.narrow(fax, target - pad, pad).add_(strip_r.narrow(fax, 0, pad))
    return core


def _ring_axes(axis_name, ndim: int, mesh) -> dict[int, str]:
    """The sharded axes (``-ndim`` for a string, or the dict's entries)
    whose mesh axis holds more than one rank."""
    sharded = axis_name if isinstance(axis_name, dict) else {-ndim: axis_name}
    return {ax: name for ax, name in sharded.items() if axis_size(mesh, name) > 1}


def _local_wavedecn(x: torch.Tensor, dec_lo, dec_hi, level: int, ndim: int, axis_name, mesh):
    """Per-rank multi-level analysis over the trailing ``ndim`` axes.

    ``axis_name`` is either a string (axis ``-ndim`` sharded, the default
    configuration) or a dict mapping negative axis offsets to mesh axis
    names (a multi-axis chip grid: each listed axis exchanges ring halos,
    the rest are local ``periodization`` levels).  Each axis pass runs on
    the packed output of the last, so a level is one launch per local axis.
    Returns ``(cA, subband-dict_level, ..., subband-dict_1)`` keyed by
    ``SUBBAND_ORDERS`` selector tuples (the caller maps to containers).
    """
    rings = _ring_axes(axis_name, ndim, mesh)
    halo = len(dec_lo) // 2 - 1
    details = []
    cur = x
    for _ in range(level):
        packed = cur
        for axis in range(-ndim, 0):
            if axis in rings:
                packed = _dwt_axis_ring(packed, axis, dec_lo, dec_hi, halo, rings[axis], mesh)
            else:
                packed = dwt_axis_packed(packed, axis, dec_lo, dec_hi, "periodization")
        # [2 (last axis bit), ..., 2 (first axis bit), B, ...]: the bit of
        # axis k (0 = first) weighs 2**k in the flat index
        bands = packed.flatten(0, ndim - 1).unbind(0)
        by_sel = {sel: bands[sum(bit << k for k, bit in enumerate(sel))] for sel in SUBBAND_ORDERS[ndim]}
        cur = by_sel[(0,) * ndim]
        details.append({sel: by_sel[sel] for sel in SUBBAND_ORDERS[ndim][1:]})
    details.reverse()
    return (cur, *details)


def _local_waverecn(coeffs, rec_lo, rec_hi, ndim: int, axis_name, mesh) -> torch.Tensor:
    """Per-rank multi-level synthesis inverting :func:`_local_wavedecn`:
    the last axis first, every pair of an axis in as few launches as K4
    takes."""
    rings = _ring_axes(axis_name, ndim, mesh)
    cur = coeffs[0]
    for det in coeffs[1:]:
        blocks = dict(det)
        blocks[(0,) * ndim] = cur
        for bit_pos in reversed(range(ndim)):
            axis = bit_pos - ndim
            keys = sorted(sel for sel in blocks if sel[bit_pos] == 0)
            los = [blocks[sel] for sel in keys]
            his = [blocks[sel[:bit_pos] + (1,) + sel[bit_pos + 1 :]] for sel in keys]
            if axis in rings:
                merged = _idwt_axis_ring(los, his, rec_lo, rec_hi, axis, rings[axis], mesh)
            else:
                merged = _idwt_pairs(los, his, axis, rec_lo, rec_hi, 0, 0, "periodization")
            blocks = {sel[:bit_pos] + sel[bit_pos + 1 :]: out for sel, out in zip(keys, merged.unbind(0))}
        cur = blocks[()]
    return cur


# ---------------------------------------------------------------------------
# checks and geometry
# ---------------------------------------------------------------------------


def _check_tileable(shard_len: int, level: int, filt_len: int, n_spatial: int, total: int) -> None:
    if total % (n_spatial * 2**level):
        raise ValueError(
            f"sharded axis ({total}) must divide by n_spatial*2^level = "
            f"{n_spatial * 2 ** level} for the tiled transform."
        )
    halo = filt_len // 2 - 1
    deepest = shard_len // 2 ** max(level - 1, 0)
    if halo > deepest:
        raise ValueError(
            f"halo of {halo} exceeds the per-device length at the deepest "
            f"level ({deepest}); use fewer levels/shards or a shorter wavelet."
        )


@host_constant(maxsize=1024)
def _padded_length_chain(n: int, filt_len: int, level: int, s: int) -> tuple[dict, ...]:
    """Host-side geometry per level for the padded tiled transforms."""
    geos = []
    cur = n
    for _ in range(level):
        geo = padded_level_geometry(cur, filt_len, s)
        geos.append(geo)
        cur = geo["m_g"]
    return tuple(geos)


# ---------------------------------------------------------------------------
# 1d
# ---------------------------------------------------------------------------


def tiled_wavedec(
    data,
    wavelet: Union[Wavelet, str],
    *,
    level: int,
    mesh,
    mode: str = "periodization",
) -> WaveletCoeff1d:
    """Sequence-parallel 1d analysis FWT.

    ``data`` is ``[batch, n]``: batch shards over ``data``, the signal axis
    over ``spatial``.  Numerically the serial
    ``wavedec(data, wavelet, mode=mode, level=level)``: ``periodization``
    uses the uniform ring tiling, the padded pywt modes the
    capacity-chunked tiling of :mod:`._padded_axis` (boundary tiles apply
    the true padding, interior tiles consume halos).  Returns a list of
    ``DTensor``s.
    """
    data = _as_input(data)
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    n_spatial = axis_size(mesh, "spatial")
    dims = _layout(mesh, ("spatial", 1))
    batch, n = data.shape[0], data.shape[-1]

    if mode == "periodization":
        _check_tileable(n // n_spatial, level, len(dec_lo), n_spatial, n)
        out = _local_wavedecn(_local(data, mesh, dims), dec_lo, dec_hi, level, 1, "spatial", mesh)
        bands = [out[0], *(d[(1,)] for d in out[1:])]
        return [_global(c, mesh, dims, batch, _spatial_lengths(c, mesh, dims)) for c in bands]

    geos = _padded_length_chain(n, len(dec_lo), level, n_spatial)
    cur = _pad_to_capacity(_local(data, mesh, dims), geos[0]["cap_in"], -1)
    details = []
    for geo in geos:
        lo, hi = sharded_dwt_level(cur, geo, dec_lo, dec_hi, mode, -1, "spatial", mesh).unbind(0)
        details.append(_global(hi, mesh, dims, batch, {1: geo["m_g"]}))
        cur = lo
    return [_global(cur, mesh, dims, batch, {1: geos[-1]["m_g"]}), *details[::-1]]


def tiled_waverec(
    coeffs: WaveletCoeff1d,
    wavelet: Union[Wavelet, str],
    *,
    mesh,
    mode: str = "periodization",
) -> DTensor:
    """Invert :func:`tiled_wavedec`; a ``DTensor`` laid out as its input."""
    coeffs = [_as_input(c) for c in coeffs]
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=coeffs[0].dtype)
    n_spatial = axis_size(mesh, "spatial")
    dims = _layout(mesh, ("spatial", 1))
    batch = coeffs[0].shape[0]

    if mode == "periodization":
        local = [_local(c, mesh, dims) for c in coeffs]
        packed = (local[0], *({(1,): d} for d in local[1:]))
        out = _local_waverecn(packed, rec_lo, rec_hi, 1, "spatial", mesh)
        return _global(out, mesh, dims, batch, _spatial_lengths(out, mesh, dims))

    filt_len = len(rec_lo)
    # Resolve the global length chain from the coefficient lengths (the
    # same next-shape disambiguation as the serial waverec), building one
    # geometry per synthesis step, deepest first.  The chunk capacities
    # chain automatically: step i's output capacity ceil(n_g/s) equals
    # step i+1's coefficient capacity ceil(m_g/s).
    lengths = [c.shape[-1] for c in coeffs]  # [cA_L, cD_L, ..., cD_1]
    geos = []
    m = lengths[0]
    for i in range(1, len(lengths)):
        if lengths[i] != m:
            raise ValueError(
                "coefficient lengths do not form a valid padded-mode chain"
            )
        pred = 2 * m - filt_len + 2
        nxt = lengths[i + 1] if i + 1 < len(lengths) else pred
        m = nxt if pred - nxt in (0, 1) else pred
        geos.append(padded_level_geometry(m, filt_len, n_spatial))
    caps = [geos[0]["cap_out"]] + [g["cap_out"] for g in geos]
    local = [_pad_to_capacity(_local(c, mesh, dims), cap, -1) for c, cap in zip(coeffs, caps)]
    cur = local[0]
    for i, geo in enumerate(geos):
        cur = sharded_idwt_level([cur], [local[1 + i]], geo, rec_lo, rec_hi, geo["n_g"], -1, "spatial", mesh)[0]
    return _global(cur, mesh, dims, batch, {1: geos[-1]["n_g"]})


# ---------------------------------------------------------------------------
# 3d
# ---------------------------------------------------------------------------


def _w_axis(mesh):
    """The second spatial mesh axis, or None."""
    return "spatial_w" if "spatial_w" in mesh.mesh_dim_names else None


def _band_dict(packed_levels) -> dict:
    return {key: packed_levels[sel] for key, sel in zip(_DETAIL_KEYS, SUBBAND_ORDERS[3][1:])}


def _padded_wavedec3(data: torch.Tensor, wavelet, level: int, mesh, mode: str):
    """Depth-sharded padded-mode 3d analysis.

    D shards over ``spatial``; with a ``spatial_w`` mesh axis H shards
    too (W stays local): a 2d chip grid over the volume's outer axes.
    """
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    filt_len = len(dec_lo)
    s = axis_size(mesh, "spatial")
    geos = _padded_length_chain(data.shape[-3], filt_len, level, s)
    h_axis = _w_axis(mesh)
    geos_h = (
        _padded_length_chain(data.shape[-2], filt_len, level, axis_size(mesh, h_axis))
        if h_axis is not None
        else None
    )
    dims = _layout(mesh, ("spatial", 1), (h_axis, 2))
    batch = data.shape[0]
    cur = _pad_to_capacity(_local(data, mesh, dims), geos[0]["cap_in"], -3)
    if geos_h is not None:
        cur = _pad_to_capacity(cur, geos_h[0]["cap_in"], -2)

    def out(c, lvl):
        lengths = {1: geos[lvl]["m_g"]}
        if geos_h is not None:
            lengths[2] = geos_h[lvl]["m_g"]
        return _global(c, mesh, dims, batch, lengths)

    details = []
    for lvl, geo in enumerate(geos):
        packed = sharded_dwt_level(cur, geo, dec_lo, dec_hi, mode, -3, "spatial", mesh)
        if geos_h is not None:
            packed = sharded_dwt_level(packed, geos_h[lvl], dec_lo, dec_hi, mode, -2, h_axis, mesh)
        else:
            packed = dwt_axis_packed(packed, -2, dec_lo, dec_hi, mode)
        packed = dwt_axis_packed(packed, -1, dec_lo, dec_hi, mode)
        # [2 (w bit), 2 (h bit), 2 (d bit), B, d, h, w]: flat index 4w + 2h + d
        bands = packed.flatten(0, 2).unbind(0)
        by_sel = {(d, h, w): bands[4 * w + 2 * h + d] for d, h, w in SUBBAND_ORDERS[3]}
        details.append({key: out(v, lvl) for key, v in _band_dict(by_sel).items()})
        cur = by_sel[(0, 0, 0)]
    return (out(cur, level - 1), *details[::-1])


def _padded_waverec3(coeffs, wavelet, mesh, mode: str) -> DTensor:
    """Invert :func:`_padded_wavedec3`."""
    coeffs = [_as_input(coeffs[0]), *({k: _as_input(v) for k, v in c.items()} for c in coeffs[1:])]
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=coeffs[0].dtype)
    filt_len = len(rec_lo)
    s = axis_size(mesh, "spatial")
    p = (2 * filt_len - 3) // 2

    h_axis = _w_axis(mesh)
    s_h = axis_size(mesh, h_axis) if h_axis is not None else 1
    geos = []
    geos_h = [] if h_axis is not None else None
    local_pads = []
    m_d, m_h, m_w = coeffs[0].shape[-3:]
    for i in range(1, len(coeffs)):
        pred_d = 2 * m_d - filt_len + 2
        pred_h = 2 * m_h - filt_len + 2
        if i + 1 < len(coeffs):
            nxt_d, nxt_h, nxt_w = coeffs[i + 1]["add"].shape[-3:]
        else:
            nxt_d = pred_d
            nxt_h = pred_h
            nxt_w = 2 * m_w - filt_len + 2
        n_d = nxt_d if pred_d - nxt_d in (0, 1) else pred_d
        n_h = nxt_h if pred_h - nxt_h in (0, 1) else pred_h
        geos.append(padded_level_geometry(n_d, filt_len, s))
        if geos_h is not None:
            geos_h.append(padded_level_geometry(n_h, filt_len, s_h))
        pads = []
        for m_ax, nxt_ax in ((m_h, nxt_h), (m_w, nxt_w)):
            padr, padl = _adjust_padding_at_reconstruction(2 * (m_ax - 1) + filt_len, nxt_ax, p, p)
            pads.append((padl, padr))
        local_pads.append(pads)
        m_d, m_h, m_w = n_d, n_h, nxt_w

    dims = _layout(mesh, ("spatial", 1), (h_axis, 2))
    batch = coeffs[0].shape[0]
    caps = [geos[0]["cap_out"]] + [g["cap_out"] for g in geos]
    caps_h = [geos_h[0]["cap_out"]] + [g["cap_out"] for g in geos_h] if geos_h is not None else None

    def prep(c, i):
        c = _pad_to_capacity(_local(c, mesh, dims), caps[i], -3)
        if caps_h is not None:
            c = _pad_to_capacity(c, caps_h[i], -2)
        return c

    cur = prep(coeffs[0], 0)
    for i, geo in enumerate(geos):
        det = {k: prep(v, i + 1) for k, v in coeffs[1 + i].items()}
        # index (d, h, w) -> 4d + 2h + w; axis -1 pairs w = 0 with w = 1
        band = [cur, *(det[key] for key in _DETAIL_KEYS)]
        (h_l, h_r), (w_l, w_r) = local_pads[i]
        lo_h = _idwt_pairs(band[0::4], band[1::4], -1, rec_lo, rec_hi, w_l, w_r, mode)  # (d, h = 0)
        hi_h = _idwt_pairs(band[2::4], band[3::4], -1, rec_lo, rec_hi, w_l, w_r, mode)  # (d, h = 1)
        if geos_h is not None:
            d_pair = sharded_idwt_level(
                lo_h.unbind(0), hi_h.unbind(0), geos_h[i], rec_lo, rec_hi, geos_h[i]["n_g"], -2, h_axis, mesh
            )
        else:
            d_pair = _idwt_pairs(lo_h.unbind(0), hi_h.unbind(0), -2, rec_lo, rec_hi, h_l, h_r, mode)
        lo, hi = d_pair.unbind(0)
        cur = sharded_idwt_level([lo], [hi], geo, rec_lo, rec_hi, geo["n_g"], -3, "spatial", mesh)[0]
    lengths = {1: geos[-1]["n_g"]}
    if geos_h is not None:
        lengths[2] = geos_h[-1]["n_g"]
    return _global(cur, mesh, dims, batch, lengths)


def tiled_wavedec3(
    data,
    wavelet: Union[Wavelet, str],
    *,
    level: int,
    mesh,
    mode: str = "periodization",
) -> WaveletCoeffNd:
    """Multi-device 3d analysis FWT.

    ``data`` is ``[batch, D, H, W]``: batch shards over ``data``, depth
    over ``spatial``; H and W stay local.  Numerically the serial
    ``wavedec3`` for every mode (periodization rides the uniform ring
    tiling; the padded pywt modes the capacity-chunked levels of
    :mod:`._padded_axis` on the depth axis).  Returns ``DTensor``s.
    """
    data = _as_input(data)
    if mode != "periodization":
        return _padded_wavedec3(data, wavelet, level, mesh, mode)
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    n_spatial = axis_size(mesh, "spatial")
    _check_tileable(data.shape[-3] // n_spatial, level, len(dec_lo), n_spatial, data.shape[-3])
    halo = len(dec_lo) // 2 - 1
    for ax in (-2, -1):
        if data.shape[ax] % 2**level:
            raise ValueError("local axes must divide by 2^level.")
        deepest = data.shape[ax] // 2 ** max(level - 1, 0)
        if halo > deepest:
            raise ValueError(
                f"halo of {halo} exceeds local axis {ax} at the deepest "
                f"level ({deepest}); use fewer levels or a shorter wavelet."
            )
    dims = _layout(mesh, ("spatial", 1))
    batch = data.shape[0]
    out = _local_wavedecn(_local(data, mesh, dims), dec_lo, dec_hi, level, 3, "spatial", mesh)

    def glob(c):
        return _global(c, mesh, dims, batch, _spatial_lengths(c, mesh, dims))

    return (glob(out[0]), *({k: glob(v) for k, v in _band_dict(d).items()} for d in out[1:]))


def tiled_waverec3(
    coeffs: WaveletCoeffNd,
    wavelet: Union[Wavelet, str],
    *,
    mesh,
    mode: str = "periodization",
) -> DTensor:
    """Invert :func:`tiled_wavedec3`; a ``DTensor`` laid out as its input."""
    if mode != "periodization":
        return _padded_waverec3(coeffs, wavelet, mesh, mode)
    approx = _as_input(coeffs[0])
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=approx.dtype)
    dims = _layout(mesh, ("spatial", 1))
    packed = (
        _local(approx, mesh, dims),
        *(
            {sel: _local(_as_input(d[key]), mesh, dims) for key, sel in zip(_DETAIL_KEYS, SUBBAND_ORDERS[3][1:])}
            for d in coeffs[1:]
        ),
    )
    out = _local_waverecn(packed, rec_lo, rec_hi, 3, "spatial", mesh)
    return _global(out, mesh, dims, approx.shape[0], _spatial_lengths(out, mesh, dims))
