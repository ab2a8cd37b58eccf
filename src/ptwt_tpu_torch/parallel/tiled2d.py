"""Tiled multi-device 2d FWT: spatial decomposition with ring halo exchange.

Counterpart of :mod:`ptwt_tpu.parallel.tiled2d`:

- Images ``[batch, H, W]`` are sharded over a ``('data', 'spatial')``
  device mesh: batch over ``data``, image *rows* over ``spatial``; W stays
  local, or shards over ``spatial_w`` in a 2d chip grid.
- ``periodization`` halves every level exactly, so coefficient shards stay
  uniform and the circular topology maps one-to-one onto a ring of P2P
  steps: each level exchanges ``filt_len // 2 - 1`` halo rows with the
  ring neighbours before (or, overlapped, while) the local strided filter
  bank runs, and each synthesis level sends the overhanging rows back.
- The padded modes (reflect/zero/periodic/symmetric/constant) produce
  per-level lengths ``N/2 + L/2 - 1`` whose extra rows straddle tile
  boundaries; they shard through the capacity-chunked levels of
  :mod:`._padded_axis` on H (and on W over ``spatial_w``), the boundary
  tiles applying the true padding mode.

The coefficients are ``DTensor``s (``Shard`` placements) whose
``full_tensor()`` gathers the serial ``wavedec2(..., mode=mode)`` bands.
Each process runs its own chunk through K3/K4 on the card (two K3 launches
per analysis level and two K4 launches per synthesis level, plus the edge
strips of a ring axis); see :mod:`.tiledn`.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..constants import Wavelet, WaveletCoeff2d, WaveletDetailTuple2d
from ..conv_transform import _adjust_padding_at_reconstruction
from ..ops._dispatch import dwt_axis_packed, idwt_axis_pairs
from ..utils import filter_taps
from ._padded_axis import padded_level_geometry, sharded_dwt_level, sharded_idwt_level
from ._ring import axis_size
from .tiledn import (
    _as_input,
    _global,
    _layout,
    _local,
    _local_wavedecn,
    _local_waverecn,
    _pad_to_capacity,
    _padded_length_chain,
    _spatial_lengths,
    _w_axis,
)

__all__ = ["make_wavelet_mesh", "tiled_wavedec2", "tiled_waverec2"]

#: Timeout of every process group of a mesh from :func:`make_wavelet_mesh`.
MESH_TIMEOUT = timedelta(minutes=5)


def make_wavelet_mesh(
    n_data: Optional[int] = None,
    n_spatial: Optional[int] = None,
    *,
    n_hosts: Optional[int] = None,
    n_spatial_w: Optional[int] = None,
    device_type: str = "cuda",
    timeout: timedelta = MESH_TIMEOUT,
) -> DeviceMesh:
    """Create the wavelet device mesh over the default process group.

    Default axes are ``('data', 'spatial')``.  Two optional hierarchy
    levels mirror real cluster topologies:

    * ``n_hosts`` adds a leading ``'host'`` axis.  Batch work shards over
      ``('host', 'data')`` jointly, so the halo rings and edge sums stay on
      the intra-host ``spatial`` axes while the host axis only carries
      independent batch shards.
    * ``n_spatial_w`` adds a trailing ``'spatial_w'`` axis for a 2d chip
      grid: :func:`tiled_wavedec2` then shards H over ``spatial`` *and* W
      over ``spatial_w``, with ring halos on both.

    ``None`` sizes are resolved against ``dist.get_world_size()``; the
    mesh runs on the card unless ``device_type="cpu"``.  Each mesh axis
    gets process groups of its own, created with ``timeout``, so that a
    rank that stops fails the others' exchanges instead of stalling them.
    Call ``torch.distributed.init_process_group`` first (``torchrun`` sets
    up its environment); every rank must call this function.

    Raises:
        ValueError: If the mesh's size is not the world size.
    """
    n_devices = dist.get_world_size()
    hosts = n_hosts or 1
    sw = n_spatial_w or 1
    rest = n_devices // (hosts * sw)
    if n_data is None and n_spatial is None:
        n_spatial = rest
        n_data = 1
    elif n_data is None:
        n_data = rest // n_spatial
    elif n_spatial is None:
        n_spatial = rest // n_data
    shape = []
    names = []
    if n_hosts is not None:
        shape.append(hosts)
        names.append("host")
    shape += [n_data, n_spatial]
    names += ["data", "spatial"]
    if n_spatial_w is not None:
        shape.append(sw)
        names.append("spatial_w")
    size = 1
    for extent in shape:
        size *= extent
    if size != n_devices:
        raise ValueError(
            f"the mesh {dict(zip(names, shape))} holds {size} ranks, but the "
            f"world has {n_devices}: its axes must multiply to the world size"
        )
    ranks = torch.arange(n_devices).reshape(shape)
    rank = dist.get_rank()
    groups = []
    for dim, extent in enumerate(shape):
        # the line of the mesh along dim through this rank; only its ranks
        # create its group and meet in its barrier
        line = next(line for line in ranks.movedim(dim, -1).reshape(-1, extent).tolist() if rank in line)
        groups.append(dist.new_group(line, timeout=timeout, use_local_synchronization=True))
    return DeviceMesh.from_group(groups, device_type, mesh=ranks, mesh_dim_names=tuple(names))


def _check_tileable(shape, level: int, filt_len: int, n_spatial: int) -> None:
    batch, height, width = shape
    halo = filt_len // 2 - 1
    if height % (n_spatial * 2**level):
        raise ValueError(
            f"H={height} must be divisible by n_spatial*2^level = "
            f"{n_spatial * 2 ** level} for the tiled transform."
        )
    if width % 2**level:
        raise ValueError(f"W={width} must be divisible by 2^level.")
    local_rows = height // n_spatial // 2 ** max(level - 1, 0)
    if halo > local_rows:
        raise ValueError(
            f"Halo of {halo} rows exceeds the per-device rows at the deepest "
            f"level ({local_rows}); use fewer levels, fewer spatial shards, "
            "or a shorter wavelet."
        )


def _padded_wavedec2(data: torch.Tensor, wavelet, level: int, mesh, mode: str):
    """Spatially tiled padded-mode 2d analysis.

    H shards over ``spatial``; with a ``spatial_w`` mesh axis W shards
    too: both axes run the capacity-chunked levels of :mod:`._padded_axis`,
    composed per level over the 2d chip grid.
    """
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    filt_len = len(dec_lo)
    s = axis_size(mesh, "spatial")
    geos = _padded_length_chain(data.shape[-2], filt_len, level, s)
    w_axis = _w_axis(mesh)
    geos_w = (
        _padded_length_chain(data.shape[-1], filt_len, level, axis_size(mesh, w_axis))
        if w_axis is not None
        else None
    )
    dims = _layout(mesh, ("spatial", 1), (w_axis, 2))
    batch = data.shape[0]
    cur = _pad_to_capacity(_local(data, mesh, dims), geos[0]["cap_in"], -2)
    if geos_w is not None:
        cur = _pad_to_capacity(cur, geos_w[0]["cap_in"], -1)

    def out(c, lvl):
        lengths = {1: geos[lvl]["m_g"]}
        if geos_w is not None:
            lengths[2] = geos_w[lvl]["m_g"]
        return _global(c, mesh, dims, batch, lengths)

    details = []
    for lvl, geo in enumerate(geos):
        rows = sharded_dwt_level(cur, geo, dec_lo, dec_hi, mode, -2, "spatial", mesh)  # [2 (H bit), B, m, w]
        if geos_w is None:
            both = dwt_axis_packed(rows, -1, dec_lo, dec_hi, mode)
        else:
            both = sharded_dwt_level(rows, geos_w[lvl], dec_lo, dec_hi, mode, -1, w_axis, mesh)
        # [2 (W bit), 2 (H bit), B, m_h, m_w]
        (ll, lh), (hl, hh) = (half.unbind(0) for half in both.unbind(0))
        details.append(WaveletDetailTuple2d(out(lh, lvl), out(hl, lvl), out(hh, lvl)))
        cur = ll
    return (out(cur, level - 1), *details[::-1])


def _padded_waverec2(coeffs, wavelet, mesh, mode: str) -> DTensor:
    """Invert :func:`_padded_wavedec2`."""
    coeffs = [_as_input(coeffs[0]), *(WaveletDetailTuple2d(*(_as_input(c) for c in t)) for t in coeffs[1:])]
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=coeffs[0].dtype)
    filt_len = len(rec_lo)
    s = axis_size(mesh, "spatial")
    w_axis = _w_axis(mesh)
    s_w = axis_size(mesh, w_axis) if w_axis is not None else 1
    p = (2 * filt_len - 3) // 2

    # resolve the global H/W-length chains from the coefficient lengths
    geos = []
    geos_w = [] if w_axis is not None else None
    w_pads = []
    m_h = coeffs[0].shape[-2]
    m_w = coeffs[0].shape[-1]
    for i in range(1, len(coeffs)):
        if coeffs[i][0].shape[-2] != m_h or coeffs[i][0].shape[-1] != m_w:
            raise ValueError("coefficient shapes do not form a valid chain")
        pred_h = 2 * m_h - filt_len + 2
        pred_w = 2 * m_w - filt_len + 2
        if i + 1 < len(coeffs):
            nxt_h, nxt_w = coeffs[i + 1][0].shape[-2:]
        else:
            nxt_h, nxt_w = pred_h, pred_w
        n_h = nxt_h if pred_h - nxt_h in (0, 1) else pred_h
        n_w = nxt_w if pred_w - nxt_w in (0, 1) else pred_w
        geos.append(padded_level_geometry(n_h, filt_len, s))
        if geos_w is not None:
            geos_w.append(padded_level_geometry(n_w, filt_len, s_w))
        padr, padl = _adjust_padding_at_reconstruction(2 * (m_w - 1) + filt_len, nxt_w, p, p)
        w_pads.append((padl, padr))
        m_h, m_w = n_h, n_w

    dims = _layout(mesh, ("spatial", 1), (w_axis, 2))
    batch = coeffs[0].shape[0]
    caps = [geos[0]["cap_out"]] + [g["cap_out"] for g in geos]
    caps_w = [geos_w[0]["cap_out"]] + [g["cap_out"] for g in geos_w] if geos_w is not None else None

    def prep(c, i):
        c = _pad_to_capacity(_local(c, mesh, dims), caps[i], -2)
        if caps_w is not None:
            c = _pad_to_capacity(c, caps_w[i], -1)
        return c

    cur = prep(coeffs[0], 0)
    for i, geo in enumerate(geos):
        lh, hl, hh = (prep(c, i + 1) for c in coeffs[1 + i])
        if geos_w is None:
            merged = idwt_axis_pairs((cur, lh), (hl, hh), -1, rec_lo, rec_hi, *w_pads[i], mode)
        else:
            merged = sharded_idwt_level(
                (cur, lh), (hl, hh), geos_w[i], rec_lo, rec_hi, geos_w[i]["n_g"], -1, w_axis, mesh
            )
        lo, hi = merged.unbind(0)
        cur = sharded_idwt_level([lo], [hi], geo, rec_lo, rec_hi, geo["n_g"], -2, "spatial", mesh)[0]
    lengths = {1: geos[-1]["n_g"]}
    if geos_w is not None:
        lengths[2] = geos_w[-1]["n_g"]
    return _global(cur, mesh, dims, batch, lengths)


def tiled_wavedec2(
    data,
    wavelet: Union[Wavelet, str],
    *,
    level: int,
    mesh,
    mode: str = "periodization",
) -> WaveletCoeff2d:
    """Multi-device 2d analysis FWT.

    Args:
        data: ``[batch, H, W]``: a ``DTensor`` with the batch sharded over
            ``data`` (and ``host``), rows over ``spatial`` (and columns
            over ``spatial_w``), or the whole tensor on every rank.
        wavelet: Wavelet name or pywt-compatible object.
        level: Number of levels (for ``periodization`` H and W must divide
            by ``2**level`` and H by the spatial shard count).
        mesh: A mesh from :func:`make_wavelet_mesh`.
        mode: ``periodization`` or a padded pywt mode.

    Returns:
        The standard ``(cA, (H, V, D), ...)`` tuple of ``DTensor``s, whose
        ``full_tensor()`` is ``wavedec2(data, wavelet, mode=mode,
        level=level)``.
    """
    data = _as_input(data)
    if mode != "periodization":
        return _padded_wavedec2(data, wavelet, level, mesh, mode)
    dec_lo, dec_hi, _, _ = filter_taps(wavelet, flip=True, dtype=data.dtype)
    n_spatial = axis_size(mesh, "spatial")
    _check_tileable(data.shape, level, len(dec_lo), n_spatial)
    w_axis = _w_axis(mesh)
    sharded = {-2: "spatial"}
    if w_axis is not None:
        _check_tileable(
            (data.shape[0], data.shape[-1], data.shape[-2]),
            level, len(dec_lo), axis_size(mesh, w_axis),
        )
        sharded[-1] = w_axis
    dims = _layout(mesh, ("spatial", 1), (w_axis, 2))
    batch = data.shape[0]
    out = _local_wavedecn(_local(data, mesh, dims), dec_lo, dec_hi, level, 2, sharded, mesh)

    def glob(c):
        return _global(c, mesh, dims, batch, _spatial_lengths(c, mesh, dims))

    return (
        glob(out[0]),
        *(WaveletDetailTuple2d(glob(d[(1, 0)]), glob(d[(0, 1)]), glob(d[(1, 1)])) for d in out[1:]),
    )


def tiled_waverec2(
    coeffs: WaveletCoeff2d,
    wavelet: Union[Wavelet, str],
    *,
    mesh,
    mode: str = "periodization",
) -> DTensor:
    """Multi-device 2d synthesis FWT inverting :func:`tiled_wavedec2`; a
    ``DTensor`` laid out as its input."""
    if mode != "periodization":
        return _padded_waverec2(coeffs, wavelet, mesh, mode)
    approx = _as_input(coeffs[0])
    _, _, rec_lo, rec_hi = filter_taps(wavelet, flip=False, dtype=approx.dtype)
    w_axis = _w_axis(mesh)
    sharded = {-2: "spatial"}
    if w_axis is not None:
        sharded[-1] = w_axis
    dims = _layout(mesh, ("spatial", 1), (w_axis, 2))
    packed = (
        _local(approx, mesh, dims),
        *(
            {sel: _local(_as_input(c), mesh, dims) for sel, c in zip(((1, 0), (0, 1), (1, 1)), t)}
            for t in coeffs[1:]
        ),
    )
    out = _local_waverecn(packed, rec_lo, rec_hi, 2, sharded, mesh)
    return _global(out, mesh, dims, approx.shape[0], _spatial_lengths(out, mesh, dims))
