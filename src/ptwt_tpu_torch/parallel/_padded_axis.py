"""Sharded-axis FWT levels for the *padded* boundary modes.

Counterpart of :mod:`ptwt_tpu.parallel._padded_axis`, with the same
geometry:

* The *global* coefficient array of valid length ``m_g`` is stored in
  ``S`` equal-capacity chunks ``cap_out = ceil(m_g / S)`` (the last chunk
  carries a garbage tail; valid lengths are tracked on the host).  These
  are exactly ``torch.chunk``'s chunks, the local shards of a ``DTensor``
  with a ``Shard`` placement, once cut to their valid rows.
* Rank ``d`` owns output rows ``[d*cap_out, (d+1)*cap_out)`` and needs the
  *extended* input window ``[2*d*cap_out - p, ... + 2*cap_out + L-2)``
  with ``p`` the pywt pad.  The halo slabs that bring the neighbours' rows
  have the static worst-case sizes over all ranks (every receive buffer
  matches its sender on every rank).
* Positions outside ``[0, n_g)`` are redirected to their mode source
  (reflect/symmetric/periodic/constant/zero) inside the window, reading
  the global head and tail edge slabs that every rank receives through one
  sum over the axis (the JAX ``psum``).
* Synthesis runs the full local transposed convolution, exchanges the
  statically bounded overlap slabs, and places contributions with discard
  margins so that the global crop falls out of the placement arithmetic.

Where the JAX package reads the rank's coordinate inside ``shard_map``
(``lax.axis_index``), this module reads it on the host
(``mesh.get_local_rank``): every offset is a Python int and every
``dynamic_slice`` a plain slice.  The geometry, the choice of edge slabs
and the mode map are host constants (:func:`~..utils._preprocess.host_constant`:
python ints and numpy arrays, made once per geometry and rank and cached),
so no branch reads a tensor and ``torch.compile`` takes them as constants
of the program, as ``jax.jit`` takes the JAX package's numpy geometry.  An
axis of one rank runs the serial level (its window is the whole extended
signal).  Each local level goes
through :func:`~ptwt_tpu_torch.ops._dispatch.dwt_axis_packed` (``valid``) and
:func:`~ptwt_tpu_torch.ops._dispatch.idwt_axis_pairs` (uncropped): K3/K4 on the card, K7a/K7b
on a local last axis longer than ``2**16`` samples.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops._dispatch import dwt_axis_packed, idwt_axis_pairs
from ..utils._preprocess import host_constant
from ._ring import BWD, FWD, edge_sum, exchange

__all__ = [
    "padded_level_geometry",
    "sharded_dwt_level",
    "sharded_idwt_level",
]


_PADDED_MODES = ("reflect", "zero", "periodic", "symmetric", "constant")


@host_constant(maxsize=1024)
def padded_level_geometry(n_g: int, filt_len: int, s: int) -> dict:
    """Static per-level geometry for a padded-mode sharded axis (host
    work, cached; the caller must not change the dict).

    Args:
        n_g: Global valid input length at this level.
        filt_len: Wavelet filter length.
        s: Number of shards along the axis.

    Returns:
        Dict of static integers (see keys in the code); raises if the
        halo geometry needs more than one ring hop.
    """
    p = (2 * filt_len - 3) // 2
    npad = n_g + 2 * p + (n_g % 2)
    m_g = (npad - filt_len) // 2 + 1
    cap_in = -(-n_g // s)
    cap_out = -(-m_g // s)
    w_in = 2 * cap_out + filt_len - 2
    # halo slab sizes (static worst case over devices)
    hl = max(0, max(d * cap_in - (2 * d * cap_out - p) for d in range(s)))
    hr = max(
        0,
        max(
            (2 * d * cap_out - p + w_in) - (d + 1) * cap_in for d in range(s)
        ),
    )
    if hl > cap_in or hr > cap_in:
        raise ValueError(
            f"padded tiling needs halos ({hl}, {hr}) beyond one neighbour "
            f"(chunk {cap_in}); use fewer shards or levels."
        )
    return dict(
        p=p, n_g=n_g, m_g=m_g, cap_in=cap_in, cap_out=cap_out,
        w_in=w_in, hl=hl, hr=hr, s=s,
    )


def _mode_index_map(pos: np.ndarray, n_g: int, mode: str) -> np.ndarray:
    """pywt's boundary index map of host positions (``zero`` has none: its
    out-of-range positions are masked instead)."""
    if mode == "periodic":
        return np.mod(pos, n_g)
    if mode == "constant":
        return np.clip(pos, 0, n_g - 1)
    if mode == "reflect":
        period = max(2 * n_g - 2, 1)
        q = np.mod(pos, period)
        return np.where(q < n_g, q, period - q)
    if mode == "symmetric":
        period = 2 * n_g
        q = np.mod(pos, period)
        return np.where(q < n_g, q, period - 1 - q)
    raise ValueError(f"Padding mode not supported for tiling: {mode}")


def _with_zeros(t: torch.Tensor, ax: int, before: int, after: int) -> torch.Tensor:
    """``t`` with ``before``/``after`` zero rows along ``ax``."""
    if not before and not after:
        return t
    zeros = [t.new_zeros([rows if i == ax else n for i, n in enumerate(t.shape)]) for rows in (before, after)]
    return torch.cat([zeros[0], t, zeros[1]], dim=ax)


def _window_start(d: int, cap_out: int, p: int) -> int:
    return 2 * d * cap_out - p


@host_constant(maxsize=1024)
def _edges_needed(n_g: int, w_in: int, cap_out: int, p: int, s: int, mode: str, e: int) -> tuple[bool, bool]:
    """Whether any rank's window reads the global head / tail edge slab
    (the same answer on every rank, so all of them take part in the sum).
    ``zero`` reads neither: its out-of-range positions are zeros."""
    head = tail = False
    if mode == "zero":
        return head, tail
    for d in range(s):
        pos = _window_start(d, cap_out, p) + np.arange(w_in)
        out = (pos < 0) | (pos >= n_g)
        if out.any():
            mapped = _mode_index_map(pos[out], n_g, mode)
            head |= bool((mapped < e).any())
            tail |= bool(((mapped >= n_g - e) & (mapped >= e)).any())
    return head, tail


@host_constant(maxsize=4096)
def _window_source(s_d: int, w_in: int, n_g: int, mode: str, e: int, want_head: bool, want_tail: bool):
    """Where each position of a rank's window (global start ``s_d``) reads
    from: for ``zero`` the mask of positions outside the signal (None where
    there is none); otherwise, where an edge slab is summed, the index into
    ``[window, head slab, tail slab]`` (the identity where the window lies
    inside the signal: every rank gathers, so the graphs stay alike and
    the sum's backward runs on every rank in one order), else None."""
    pos = s_d + np.arange(w_in)
    needs_map = (pos < 0) | (pos >= n_g)
    if mode == "zero":
        return needs_map if needs_map.any() else None
    if not (want_head or want_tail):
        return None
    mapped = _mode_index_map(pos, n_g, mode)
    index = np.arange(w_in)
    head_at = w_in
    tail_at = w_in + (e if want_head else 0)
    if want_tail:
        in_tail = needs_map & (mapped >= n_g - e)
        index = np.where(in_tail, tail_at + np.clip(mapped - (n_g - e), 0, e - 1), index)
    if want_head:
        in_head = needs_map & (mapped < e)
        index = np.where(in_head, head_at + np.clip(mapped, 0, e - 1), index)
    return index


def sharded_dwt_level(
    cur: torch.Tensor,
    geo: dict,
    dec_lo,
    dec_hi,
    mode: str,
    axis: int,
    axis_name: str,
    mesh,
) -> torch.Tensor:
    """One padded-mode analysis level along the sharded ``axis``.

    ``cur`` is the local chunk (capacity ``geo['cap_in']``; valid length
    bookkeeping is global and on the host).  Returns the local ``(lo, hi)``
    chunks of capacity ``geo['cap_out']``, packed ``[2, ...]`` as
    :func:`~ptwt_tpu_torch.ops._dispatch.dwt_axis_packed` packs them.
    """
    if mode not in _PADDED_MODES:
        raise ValueError(f"Padding mode not supported for tiling: {mode}")
    ax = axis % cur.ndim
    p, n_g, s = geo["p"], geo["n_g"], geo["s"]
    cap_in, w_in = geo["cap_in"], geo["w_in"]
    hl, hr = geo["hl"], geo["hr"]
    if s == 1:
        return dwt_axis_packed(cur, ax, dec_lo, dec_hi, mode)
    d = mesh.get_local_rank(axis_name)

    slabs, directions = [], []
    if hl:
        slabs.append(cur.narrow(ax, cap_in - hl, hl))
        directions.append(FWD)
    if hr:
        slabs.append(cur.narrow(ax, 0, hr))
        directions.append(BWD)
    received = exchange(slabs, directions, axis_name, mesh) if slabs else []
    parts = [received[0]] if hl else []
    parts.append(cur)
    if hr:
        parts.append(received[-1])
    buf = torch.cat(parts, dim=ax) if len(parts) > 1 else cur
    # global start of this rank's window, and its offset inside buf
    s_d = _window_start(d, geo["cap_out"], p)
    win = buf.narrow(ax, s_d - d * cap_in + hl, w_in)

    # Boundary-mode extension: out-of-range positions map to sources that
    # may sit at the *far* end of the signal (periodic wrap), so every rank
    # gets a copy of the small global head/tail edge slabs (one sum over
    # the axis of each rank's overlap with the edge ranges) and
    # out-of-range reads resolve against them.
    filt_len = len(dec_lo)
    e = min(n_g, 2 * filt_len)
    want_head, want_tail = _edges_needed(n_g, w_in, geo["cap_out"], p, s, mode, e)
    edges = []
    for wanted, start_g in ((want_head, 0), (want_tail, n_g - e)):
        if wanted:
            # this rank's rows of [start_g, start_g + e), zeros elsewhere;
            # an empty slice where it has none, so that every rank's sum
            # (and its backward) hangs off its chunk
            lo = min(max(start_g, d * cap_in), start_g + e)
            hi = max(lo, min(start_g + e, (d + 1) * cap_in))
            own = cur.narrow(ax, min(max(lo - d * cap_in, 0), cap_in), hi - lo)
            edges.append(_with_zeros(own, ax, lo - start_g, start_g + e - hi))

    source = _window_source(s_d, w_in, n_g, mode, e, want_head, want_tail)
    if mode == "zero" and source is not None:
        shape = [1] * win.ndim
        shape[ax] = w_in
        win = win.masked_fill(torch.as_tensor(source, device=cur.device).reshape(shape), 0)
    elif edges:
        summed = edge_sum(torch.cat(edges, dim=ax), axis_name, mesh)
        win = torch.index_select(torch.cat([win, summed], dim=ax), ax, torch.as_tensor(source, device=cur.device))
    return dwt_axis_packed(win, ax, dec_lo, dec_hi, "valid")


@host_constant(maxsize=1024)
def _synthesis_margins(p: int, cap_out: int, s: int, n_out: int, filt_len: int) -> tuple[int, int, int]:
    """``(cap_fin, margin_l, margin_r)`` of a synthesis level; raises where
    the overlap exceeds one chunk."""
    cap_fin = -(-n_out // s)
    f_len = 2 * (cap_out - 1) + filt_len
    # rank d's contribution covers x coords [2*d*cap_out - p, ... + f_len)
    drift_terms = [2 * dd * cap_out - p - dd * cap_fin for dd in range(s)]
    margin_l = max(0, -min(drift_terms))
    margin_r = max(0, max(t + f_len for t in drift_terms) - cap_fin)
    # one extra row absorbs the odd-length crop (n_out < s*cap_fin tail)
    margin_r = max(margin_r, s * cap_fin - n_out)
    if margin_l > cap_fin:
        raise ValueError(
            f"synthesis overlap ({margin_l}) exceeds the chunk ({cap_fin}); "
            "use fewer shards or levels."
        )
    if margin_r > cap_fin:
        raise ValueError("overlap exceeds one chunk; reduce shards.")
    return cap_fin, margin_l, margin_r


def sharded_idwt_level(
    los: Sequence[torch.Tensor],
    his: Sequence[torch.Tensor],
    geo: dict,
    rec_lo,
    rec_hi,
    n_out: int,
    axis: int,
    axis_name: str,
    mesh,
) -> torch.Tensor:
    """One padded-mode synthesis level along the sharded ``axis``, for each
    (lo, hi) pair (as :func:`~ptwt_tpu_torch.ops._dispatch.idwt_axis_pairs` takes them).

    The bands are local chunks of capacity ``geo['cap_out']``; ``n_out`` is
    the (host-resolved) global output length.  Returns the pairs' local
    chunks of capacity ``cap_fin = ceil(n_out / s)``, stacked ``[G, ...]``.
    """
    ax = axis % los[0].ndim
    filt_len = len(rec_lo)
    p, cap_out = geo["p"], geo["cap_out"]
    cap_fin, margin_l, margin_r = _synthesis_margins(p, cap_out, geo["s"], n_out, filt_len)
    f_len = 2 * (cap_out - 1) + filt_len
    if geo["s"] == 1:  # the serial level: crop p on the left, keep n_out
        return idwt_axis_pairs(los, his, ax, rec_lo, rec_hi, p, f_len - p - n_out, "zero")
    d = mesh.get_local_rank(axis_name)

    # full local transposed convolution (uncropped), [G, ...]
    full = idwt_axis_pairs(los, his, ax, rec_lo, rec_hi, 0, 0, "valid")
    fax = ax + 1
    # place it into a buffer with discard margins: rows outside the valid
    # global range [0, n_out) (the global crop and the garbage-tail
    # contributions) are zero and never exchanged
    buf_len = margin_l + cap_fin + margin_r
    start = (2 * d * cap_out - p) - d * cap_fin + margin_l
    keep_lo = max(0, margin_l - d * cap_fin)
    keep_hi = min(buf_len, n_out - d * cap_fin + margin_l)
    # the kept rows [a, b); an empty slice where none is kept, so that every
    # rank's buffer (and the exchange's backward) hangs off its bands
    a = min(max(start, keep_lo), start + f_len)
    b = max(a, min(start + f_len, keep_hi))
    buf = _with_zeros(full.narrow(fax, a - start, b - a), fax, a, buf_len - b)

    core = buf.narrow(fax, margin_l, cap_fin)
    slabs, directions = [], []
    if margin_l:  # to the left neighbour, added to its last margin_l rows
        slabs.append(buf.narrow(fax, 0, margin_l))
        directions.append(BWD)
    if margin_r:  # to the right neighbour, added to its first margin_r rows
        slabs.append(buf.narrow(fax, margin_l + cap_fin, margin_r))
        directions.append(FWD)
    if not slabs:
        return core
    received = exchange(slabs, directions, axis_name, mesh)
    core = core.clone()
    if margin_l:
        core.narrow(fax, cap_fin - margin_l, margin_l).add_(received[0])
    if margin_r:
        core.narrow(fax, 0, margin_r).add_(received[-1])
    return core
