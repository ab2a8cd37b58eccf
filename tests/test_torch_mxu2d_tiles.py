"""K9a and K9b (``csrc/mxu2d.cu``) replayed block by block in numpy.

The kernels run only on the card, so this file replays what each block of
a launch does, in float64, at the kernel's own shared-memory offsets:

* the tile plan of ``ops/_mxu2d.py`` (``analysis_plan``/``synthesis_plan``,
  the ints the kernels take) and the persistent grid's walk over the
  tiles, each block with its ring of staged windows (two or three deep);
* the fragment tables, built lane by lane as the kernels build them, and
  every fragment load at the lanes' ldmatrix row addresses;
* each staging path (a window inside the image or band, 16-byte copies
  where a chunk lies inside, element copies with the modulo or a zero
  fill off its edge, zero rows), into
  shared buffers that start as NaN, with every staged element stamped with
  its tile: every read must find an element staged for the tile that reads
  it, inside its buffer;
* the fold of K9a's VJP (band rows and columns past half the period);
* the outputs, stored straight from the second pass's fragments, every
  one written exactly once.

The products run in float64 (the kernels' 3xTF32 split is a precision
device of the card, held there against the plain versions at 2e-5).  The
replay meets the plain versions of ``ops/_mxu2d.py`` within 1e-12, the
float64 adjoint identity of each kernel and its VJP instance, and, through
the glue of ``ops/_pallas2d.py``, the JAX package's K9 in interpret mode
and ``jax.vjp`` through it.  Shapes: the periodic headline's level 1
(``m = 515``, ragged tiles) and periodization, a ragged ``384 x 768``
image, db4, sym6, db20 and an odd 7-tap bank.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _model_launch

from ptwt_tpu.ops import _pallas2d as j2d
from ptwt_tpu.ops._dispatch import analysis_nd as j_analysis_nd
from ptwt_tpu.ops._dispatch import synthesis_nd as j_synthesis_nd
from ptwt_tpu.wavelets import Wavelet
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _mxu2d as t9
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d
from _torch_one_thread import one_torch_thread  # noqa: F401

_SOURCE = (Path(__file__).resolve().parents[1] / "src/ptwt_tpu_torch/csrc/mxu2d.cu").read_text()


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", _SOURCE).group(1))


WARPS = _define("MXU_THREADS") // 32
UNITS = {name: _define(name) for name in ("ANA_UNITS_W", "ANA_UNITS_H", "SYN_UNITS_W", "SYN_UNITS_H")}
TOL = 1e-12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wrap(r, period: int, n: int):
    """``wrap_index`` of ``csrc/common.cuh``, elementwise."""
    return np.minimum(np.mod(r, period), n - 1)


# ---------------------------------------------------------------------------
# fragments: the lanes' addresses and values
# ---------------------------------------------------------------------------


def _a_index(stride: int) -> np.ndarray:
    """Offsets of the 16 x 8 A operand ldmatrix.x4 gives: lane l addresses
    row l % 16, words 4 (l // 16) ..; register i of lane (g, t) is word t
    of the row that lane 8 i + g addressed, and holds a_i: (g, t), (g + 8,
    t), (g, t + 4), (g + 8, t + 4)."""
    lanes = np.arange(32)
    addr = (lanes & 15) * stride + 4 * (lanes >> 4)
    assert (addr % 4 == 0).all()
    idx = np.empty((16, 8), np.int64)
    for i in range(4):
        for g in range(8):
            for t in range(4):
                idx[g + 8 * (i & 1), t + 4 * (i >> 1)] = addr[8 * i + g] + t
    return idx


def _b_index(stride: int) -> np.ndarray:
    """Offsets of the 8 x 8 B operand ``[k, n]`` ldmatrix.x2 gives from a
    tile stored n-major: lane l addresses row l % 8, words 4 (l // 8 % 2)
    ..; register i of lane (g, t) holds b_i = (k = t + 4 i, n = g)."""
    lanes = np.arange(32)
    addr = (lanes & 7) * stride + 4 * ((lanes >> 3) & 1)
    idx = np.empty((8, 8), np.int64)
    for i in range(2):
        for g in range(8):
            for t in range(4):
                idx[t + 4 * i, g] = addr[8 * i + g] + t
    return idx


def _c_index(stride: int, transposed: bool) -> np.ndarray:
    """Where the 16 x 8 C fragment lands: element (g + 8 h, 2 t + e) at
    ``row * stride + col`` (``store_c``) or ``col * stride + row``
    (``store_c_t``)."""
    rows, cols = np.arange(16)[:, None], np.arange(8)[None, :]
    return cols * stride + rows if transposed else rows * stride + cols


def _tap(f, k: int) -> float:
    return f[k] if 0 <= k < len(f) else 0.0


def _lanes(e: int):
    """The k-step, filter and lane (g, t) of table entry ``e``."""
    return e >> 6, (e >> 5) & 1, (e & 31) >> 2, e & 3


def _b_table(lo, hi, steps: int, c: int, step: int, k_sign: int, n_sign: int) -> np.ndarray:
    """``build_table`` of ``csrc/mxu2d.cu``: the B fragments ``[steps, 2,
    8, 8]`` (``[s, filter, k, n]``) as the lanes of entry ``(2 s + f) * 32
    + lane`` hold them, ``B[k][n] = f[c + step s + k_sign k + n_sign n]``."""
    tab = np.full((steps, 2, 8, 8), np.nan)
    for e in range(steps * 64):
        s, f, g, t = _lanes(e)
        taps = (lo, hi)[f]
        k = c + step * s + k_sign * t + n_sign * g
        tab[s, f, t, g], tab[s, f, t + 4, g] = _tap(taps, k), _tap(taps, k + 4 * k_sign)
    assert not np.isnan(tab).any()
    return tab


def _analysis_tables(lo, hi, plan):
    """FW's and FH's B fragments as K9a's lanes hold them: ``B[k][n] =
    f[8s + k - 2n - off]`` (window columns of band column n) and ``f[8s +
    k - 2n]`` (rows of Y of band row n)."""
    off, kw, kh = plan[2:5]
    return _b_table(lo, hi, kw, -off, 8, 1, -2), _b_table(lo, hi, kh, 0, 8, 1, -2)


def _synthesis_tables(lo, hi, plan):
    """SW's and SH's B fragments as K9b's lanes hold them: ``B[k][n] =
    rec[e_w + n + 2 o - 2 base - 16s - 2k]`` and ``rec[e_h + n - 16s -
    2k]``."""
    e_h, e_w, o, base, ks, kw = plan[4:10]
    sw = _b_table(lo, hi, kw, e_w + 2 * o - 2 * base, -16, -2, 1)
    return sw, _b_table(lo, hi, ks, e_h, -16, -2, 1)


def _units(n: int, per_warp: int) -> np.ndarray:
    """The products of a pass in the order the warps take them (warp w:
    ``u0 = w, w + WARPS * per_warp, ...``, then ``u0 + WARPS * i``); each
    must come up exactly once."""
    seen = [
        u0 + WARPS * i
        for warp in range(WARPS)
        for u0 in range(warp, n, WARPS * per_warp)
        for i in range(per_warp)
        if u0 + WARPS * i < n
    ]
    assert sorted(seen) == list(range(n))
    return np.asarray(seen, np.int64)


class _Block:
    """One block's shared buffers: the ring of ``stages`` stages and the
    pass buffer, NaN at the start, with the tile that wrote each element."""

    def __init__(self, stage: int, stages: int, between: int):
        self.stage = stage
        self.ring = np.full(stages * stage, np.nan)
        self.ring_tile = np.full(stages * stage, -1)
        self.mid = np.full(between, np.nan)
        self.mid_tile = np.full(between, -1)

    def read(self, buf: str, idx, tile: int, lo: int, hi: int):
        """Values at ``idx``: inside ``[lo, hi)`` and written for ``tile``."""
        vals, owner = (self.ring, self.ring_tile) if buf == "ring" else (self.mid, self.mid_tile)
        assert idx.min() >= lo and idx.max() < hi, "a read left its region"
        assert (owner[idx] == tile).all(), "a read found an element not written for its tile"
        assert not np.isnan(vals[idx]).any()
        return vals[idx]

    def write(self, buf: str, idx, values, tile: int, lo: int, hi: int):
        """Write once per tile inside ``[lo, hi)``."""
        vals, owner = (self.ring, self.ring_tile) if buf == "ring" else (self.mid, self.mid_tile)
        idx = np.asarray(idx).ravel()
        assert idx.min() >= lo and idx.max() < hi, "a write left its region"
        assert np.unique(idx).size == idx.size, "an element was written twice"
        assert (owner[idx] != tile).all(), "an element was written twice for one tile"
        vals[idx] = np.asarray(values).ravel()
        owner[idx] = tile


def _paths():
    return {"inside": 0, "vector": 0, "element": 0, "zero": 0}


def _store(out, idx, values):
    """Each output written once."""
    flat = out.reshape(-1)
    assert np.unique(idx).size == idx.size and np.isnan(flat[idx]).all(), "an output was written twice"
    flat[idx] = values


# ---------------------------------------------------------------------------
# K9a
# ---------------------------------------------------------------------------


def _analysis_tile(plan, tile: int, m_h: int, m_w: int) -> dict:
    tm, tn, _, kw, kh = plan[:5]
    tiles_h, tiles_w = plan[9:11]
    b, rest = divmod(tile, tiles_h * tiles_w)
    ty, tx = divmod(rest, tiles_w)
    i0, j0 = ty * tm, tx * tn
    rows, cols = min(tm, m_h - i0), min(tn, m_w - j0)
    nbs, ncs = _cdiv(rows, 8), _cdiv(cols, 16)
    xr, xc = _cdiv(16 * (nbs - 1) + 8 * kh, 16) * 16, 32 * (ncs - 1) + 16 + 8 * kw
    return dict(b=b, i0=i0, j0=j0, rows=rows, cols=cols, nbs=nbs, ncs=ncs, xr=xr, xc=xc)


def _stage_rows_cols(img, rows, cols, row_in, col_in, vector, inside, paths):
    """The staged values of a window: ``img[rows][cols]`` (4-column chunks
    ``cols[chunk]``), zero where a row or element lies out, counted by the
    staging path that copies each chunk (``inside``: the whole window lies
    in the image or band, 16-byte or element copies with no index map)."""
    elements = img[rows[:, None, None], cols[None]] * col_in[None]
    interior = img[rows[:, None, None], np.clip(cols, 0, img.shape[1] - 1)[None]]
    values = np.where(vector[..., None], interior, elements) * row_in[:, None, None]
    n = vector.size
    if inside:
        paths["inside"] += n
    else:
        paths["vector"] += int(vector.sum())
        paths["zero"] += int((~row_in).sum()) * vector.shape[1]
        paths["element"] += int((row_in[:, None] & ~vector).sum())
    return values


def _analysis_stage(blk, at, tile, tl, x, plan, geom, paths):
    """``ana_stage``: X[r][c] = X(2 i0 - pad + r, 2 j0 - pad - off + c)."""
    _, h, w = x.shape
    per_h, per_w, pad, circular = geom
    off, xrows, xcols, sx = plan[2], plan[5], plan[6], plan[7]
    assert tl["xr"] <= xrows and tl["xc"] <= xcols
    r0, c0 = 2 * tl["i0"] - pad, 2 * tl["j0"] - pad - off
    gr = r0 + np.arange(tl["xr"])
    if circular:
        row_in, src_row = np.ones(gr.shape, bool), _wrap(gr, per_h, h)
    else:
        row_in = (gr >= 0) & (gr < h)
        src_row = np.where(row_in, gr, 0)
    gc = c0 + 4 * np.arange(tl["xc"] // 4)  # chunk starts
    cols = gc[:, None] + np.arange(4)  # [chunk, 4]
    if circular:
        col_in, src_col = np.ones(cols.shape, bool), _wrap(cols, per_w, w)
    else:
        col_in = (cols >= 0) & (cols < w)
        src_col = np.where(col_in, cols, 0)
    inside = r0 >= 0 and r0 + tl["xr"] <= h and c0 >= 0 and c0 + tl["xc"] <= w
    vector = row_in[:, None] & (w % 4 == 0) & (gc >= 0)[None] & (gc + 4 <= w)[None]
    values = _stage_rows_cols(x[tl["b"]], src_row, src_col, row_in, col_in, vector, inside, paths)
    idx = at + np.arange(tl["xr"])[:, None, None] * sx + 4 * np.arange(tl["xc"] // 4)[None, :, None]
    blk.write("ring", idx + np.arange(4), values, tile, at, at + blk.stage)


def _ring(blk, plan_stage, stages, tiles, stage):
    """The persistent block's walk: ``stages - 1`` tiles staged ahead, then
    for tile k the tile ``k + stages - 1`` into the stage tile ``k - 1``
    left; yields ``(k, tile, offset of its stage)``."""
    for j in range(min(stages - 1, len(tiles))):
        stage(blk, j * plan_stage, tiles[j])
    for k, tile in enumerate(tiles):
        if k + stages - 1 < len(tiles):
            stage(blk, ((k + stages - 1) % stages) * plan_stage, tiles[k + stages - 1])
        yield k, tile, (k % stages) * plan_stage


def replay_analysis(x, lo, hi, per_h, per_w, m_h, m_w, pad, circular, grid=7, paths=None):
    """K9a on ``[B, h, w]`` (float64) -> ``[4, B, m_h, m_w]``: a launch of
    ``grid`` persistent blocks, each replayed in turn."""
    paths = _paths() if paths is None else paths
    b_, _, _ = x.shape
    plan = t9.analysis_plan(len(lo), pad, m_h, m_w)
    tm, tn, _, kw, kh, _, _, sx, sy, tiles_h, tiles_w, xbuf, stages = plan
    assert t9.analysis_smem(plan) <= t9.SMEM_LIMIT
    fw, fh = _analysis_tables(lo, hi, plan)
    a_x, a_y = _a_index(sx), _a_index(sy)
    c_t = _c_index(sy, True)
    geom = (per_h, per_w, pad, circular)
    out = np.full((4, b_, m_h, m_w), np.nan)
    total = b_ * tiles_h * tiles_w

    def stage(blk, at, tile):
        _analysis_stage(blk, at, tile, _analysis_tile(plan, tile, m_h, m_w), x, plan, geom, paths)

    for block in range(min(grid, total)):
        blk = _Block(xbuf, stages, 2 * tn * sy)
        for _, tile, cur in _ring(blk, xbuf, stages, list(range(block, total, grid)), stage):
            tl = _analysis_tile(plan, tile, m_h, m_w)
            ncs, nbs = tl["ncs"], tl["nbs"]
            # W pass: (16 window rows, 8 band columns), both filters, into Y^T
            nts = 2 * ncs
            u = _units(tl["xr"] // 16 * nts, UNITS["ANA_UNITS_W"])
            mt, j = u // nts, u % nts
            base = cur + 16 * mt * sx + 16 * j
            idx = base[:, None, None, None] + 8 * np.arange(kw)[None, :, None, None] + a_x
            y = np.einsum("usij,sfjk->ufik", blk.read("ring", idx, tile, cur, cur + xbuf), fw)
            dst = (np.arange(2)[None, :, None, None] * tn + 8 * j[:, None, None, None]) * sy
            blk.write("mid", dst + 16 * mt[:, None, None, None] + c_t, y, tile, 0, 2 * tn * sy)
            # H pass: (16 band columns, 8 band rows, W filter), both H filters
            u = _units(ncs * nbs * 2, UNITS["ANA_UNITS_H"])
            fw_, nb, mc = u & 1, (u >> 1) // ncs, (u >> 1) % ncs
            base = (fw_ * tn + 16 * mc) * sy + 16 * nb
            idx = base[:, None, None, None] + 8 * np.arange(kh)[None, :, None, None] + a_y
            res = np.einsum("usij,sfjk->ufik", blk.read("mid", idx, tile, 0, 2 * tn * sy), fh)
            # C[m = band column 16 mc + m][n = band row 8 nb + n] of band 2 fw + fh
            band = 2 * fw_[:, None, None, None] + np.arange(2)[None, :, None, None]
            col = 16 * mc[:, None, None, None] + np.arange(16)[None, None, :, None]
            row = 8 * nb[:, None, None, None] + np.arange(8)[None, None, None, :]
            keep = np.broadcast_to((row < tl["rows"]) & (col < tl["cols"]), res.shape)
            flat = ((band * b_ + tl["b"]) * m_h + tl["i0"] + row) * m_w + tl["j0"] + col
            _store(out, np.broadcast_to(flat, res.shape)[keep], res[keep])
    assert not np.isnan(out).any(), "a band position was never written"
    return out


# ---------------------------------------------------------------------------
# K9b
# ---------------------------------------------------------------------------


def _synthesis_tile(plan, tile: int, out_h: int, out_w: int) -> dict:
    tu, tv, dq_h, dq_w, _, _, o, base, ks, kw = plan[:10]
    tiles_h, tiles_w = plan[14:16]
    b, rest = divmod(tile, tiles_h * tiles_w)
    ty, tx = divmod(rest, tiles_w)
    u0, v0 = ty * tu, tx * tv
    rows, cols = min(tu, out_h - u0), min(tv, out_w - v0)
    nbs, ncs = _cdiv(rows, 8), _cdiv(cols, 16)
    br, bc = _cdiv(4 * (nbs - 1) + 8 * ks, 16) * 16, 8 * (ncs - 1) + 4 + base + 8 * kw
    return dict(b=b, u0=u0, v0=v0, rows=rows, cols=cols, nbs=nbs, ncs=ncs, br=br, bc=bc,
                q0=u0 // 2 + dq_h, c0=v0 // 2 + dq_w - o)


def _synthesis_stage(blk, at, tile, tl, bands, plan, geom, paths):
    """``syn_stage`` and, in the fold instance, ``syn_fold``."""
    _, m_h, m_w = bands[0].shape
    circular, half_h, half_w = geom
    brows, bcols, sb = plan[10], plan[11], plan[12]
    assert tl["br"] <= brows and tl["bc"] <= bcols
    plane = brows * sb
    qa = tl["q0"] + np.arange(tl["br"])
    if circular:
        row_in, src_row = np.ones(qa.shape, bool), _wrap(qa, half_h, half_h)
    else:
        row_in = (qa >= 0) & (qa < m_h)
        src_row = np.where(row_in, qa, 0)
    qb = tl["c0"] + 4 * np.arange(tl["bc"] // 4)
    cols = qb[:, None] + np.arange(4)
    if circular:
        col_in, src_col = np.ones(cols.shape, bool), _wrap(cols, half_w, half_w)
    else:
        col_in = (cols >= 0) & (cols < m_w)
        src_col = np.where(col_in, cols, 0)
    lim_h, lim_w = (half_h, half_w) if circular else (m_h, m_w)
    inside = tl["q0"] >= 0 and tl["q0"] + tl["br"] <= lim_h and tl["c0"] >= 0 and tl["c0"] + tl["bc"] <= lim_w
    vector = row_in[:, None] & (m_w % 4 == 0) & (qb >= 0)[None] & (qb + 4 <= lim_w)[None]
    idx = at + np.arange(tl["br"])[:, None, None] * sb + 4 * np.arange(tl["bc"] // 4)[None, :, None]
    idx = idx + np.arange(4)
    for o, band in enumerate(bands):
        values = _stage_rows_cols(band[tl["b"]], src_row, src_col, row_in, col_in, vector, inside, paths)
        blk.write("ring", idx + o * plane, values, tile, at, at + blk.stage)


def _synthesis_fold(blk, cur, tile, tl, bands, plan, half_h, half_w):
    """``syn_fold``, after the stage lands: each window position whose band
    row or column has rows past half, taken once from a flat list (the
    window rows of band rows k < xh whole, then in the other rows the
    window columns of band columns i < xw), adds the band positions half a
    period further (m < 2 half: one more term per axis); the positions are
    those the folded band says collect more."""
    _, m_h, m_w = bands[0].shape
    brows, bcols, sb = plan[10], plan[11], plan[12]
    xh, xw = m_h - half_h, m_w - half_w
    assert m_h < 2 * half_h and m_w < 2 * half_w and brows <= half_h and bcols <= half_w
    plane = brows * sb
    ra0 = (tl["q0"] + np.arange(tl["br"])) % half_h
    rb0 = (tl["c0"] + np.arange(tl["bc"])) % half_w
    extra = (ra0[:, None] < xh) | (rb0[None, :] < xw)
    skip = tl["q0"] >= xh and tl["q0"] + tl["br"] <= half_h and tl["c0"] >= xw and tl["c0"] + tl["bc"] <= half_w
    items = []
    for f in range(0 if skip else xh * tl["bc"] + tl["br"] * xw):
        if f < xh * tl["bc"]:
            a0, c = divmod(f, tl["bc"])
            r, rb = (a0 - tl["q0"]) % half_h, rb0[c]
        else:
            r, rb = divmod(f - xh * tl["bc"], xw)
            a0, c = ra0[r], (rb - tl["c0"]) % half_w
            if a0 < xh:
                continue
        if r < tl["br"] and c < tl["bc"]:
            items.append((r, c, a0, rb))
    assert len({(r, c) for r, c, _, _ in items}) == len(items), "a fold position was taken twice"
    assert {(r, c) for r, c, _, _ in items} == set(zip(*np.nonzero(extra))), "the fold list missed a position"
    for r, c, a0, rb in items:
        for o, band in enumerate(bands):
            img = band[tl["b"]]
            add = (img[a0 + half_h, rb] if a0 < xh else 0.0) + (img[a0, rb + half_w] if rb < xw else 0.0)
            add += img[a0 + half_h, rb + half_w] if a0 < xh and rb < xw else 0.0
            pos = cur + o * plane + r * sb + c
            assert blk.ring_tile[pos] == tile
            blk.ring[pos] += add


def replay_synthesis(bands, lo, hi, out_h, out_w, off, circular, fold=None, grid=7, paths=None):
    """K9b on four ``[B, m_h, m_w]`` bands (float64) -> ``[B, out_h,
    out_w]`` with K2's ``fold = (half_h, half_w, per_h, per_w)``."""
    paths = _paths() if paths is None else paths
    b_, m_h, m_w = bands[0].shape
    half_h, half_w, per_h, per_w = fold or (m_h, m_w, out_h, out_w)
    assert (per_h, per_w) == (out_h, out_w)
    plan = t9.synthesis_plan(len(lo), off, off, m_h, m_w, out_h, out_w)
    tu, tv = plan[:2]
    base, ks, kw, brows, _, sb, st, tiles_h, tiles_w, bbuf, stages = plan[7:18]
    fold_launch = circular and (half_h < m_h or half_w < m_w)
    assert t9.synthesis_smem(plan) <= t9.SMEM_LIMIT
    sw, sh = _synthesis_tables(lo, hi, plan)
    a_b, a_t = _a_index(sb), _a_index(st)
    c_t = _c_index(st, True)
    geom = (circular, half_h, half_w)
    plane = brows * sb
    out = np.full((b_, out_h, out_w), np.nan)
    total = b_ * tiles_h * tiles_w

    def stage(blk, at, tile):
        tl = _synthesis_tile(plan, tile, out_h, out_w)
        _synthesis_stage(blk, at, tile, tl, bands, plan, geom, paths)

    for block in range(min(grid, total)):
        blk = _Block(bbuf, stages, 2 * tv * st)
        for _, tile, cur in _ring(blk, bbuf, stages, list(range(block, total, grid)), stage):
            tl = _synthesis_tile(plan, tile, out_h, out_w)
            ncs, nbs = tl["ncs"], tl["nbs"]
            if fold_launch:
                _synthesis_fold(blk, cur, tile, tl, bands, plan, half_h, half_w)
            # W pass: (16 band rows, 8 output columns): T_lo = ll SW_lo + hl
            # SW_hi, T_hi = lh SW_lo + hh SW_hi, into T^T
            nts = 2 * ncs
            u = _units(tl["br"] // 16 * nts, UNITS["SYN_UNITS_W"])
            mt, n = u // nts, u % nts
            start = cur + 16 * mt * sb + 4 * n + base
            idx = start[:, None, None, None] + 8 * np.arange(kw)[None, :, None, None] + a_b
            ll, lh, hl, hh = (blk.read("ring", idx + o * plane, tile, cur, cur + bbuf) for o in range(4))
            t_lo = np.einsum("usij,sjk->uik", ll, sw[:, 0]) + np.einsum("usij,sjk->uik", hl, sw[:, 1])
            t_hi = np.einsum("usij,sjk->uik", lh, sw[:, 0]) + np.einsum("usij,sjk->uik", hh, sw[:, 1])
            dst = (np.arange(2)[None, :, None, None] * tv + 8 * n[:, None, None, None]) * st
            dst = dst + 16 * mt[:, None, None, None] + c_t
            blk.write("mid", dst, np.stack((t_lo, t_hi), 1), tile, 0, 2 * tv * st)
            # H pass: (16 output columns, 8 output rows): out^T = T_lo^T SH_lo^T
            # + T_hi^T SH_hi^T
            u = _units(ncs * nbs, UNITS["SYN_UNITS_H"])
            nb, mc = u // ncs, u % ncs
            start = 16 * mc * st + 4 * nb
            idx = start[:, None, None, None] + 8 * np.arange(ks)[None, :, None, None] + a_t
            res = sum(
                np.einsum("usij,sjk->uik", blk.read("mid", idx + f * tv * st, tile, 0, 2 * tv * st), sh[:, f])
                for f in range(2)
            )
            col = 16 * mc[:, None, None] + np.arange(16)[None, :, None]
            row = 8 * nb[:, None, None] + np.arange(8)[None, None, :]
            keep = np.broadcast_to((row < tl["rows"]) & (col < tl["cols"]), res.shape)
            flat = (tl["b"] * out_h + tl["u0"] + row) * out_w + tl["v0"] + col
            _store(out, np.broadcast_to(flat, res.shape)[keep], res[keep])
    assert not np.isnan(out).any(), "an output was never written"
    return out


# ---------------------------------------------------------------------------
# the replay against the plain versions, float64
# ---------------------------------------------------------------------------


def _bank(name):
    """Correlation-order analysis taps and plain synthesis taps; ``odd7``
    is a user's 7-tap bank (unit-norm taps on average, so its bands keep
    the input's magnitude)."""
    if name == "odd7":
        rs = np.random.RandomState(80)
        return tuple(tuple(rs.randn(7) / np.sqrt(7)) for _ in range(4))
    w = Wavelet(name)
    return (tuple(np.asarray(w.dec_lo, float)[::-1]), tuple(np.asarray(w.dec_hi, float)[::-1]),
            tuple(np.asarray(w.rec_lo, float)), tuple(np.asarray(w.rec_hi, float)))


def _geometry(h: int, w: int, L: int, mode: str):
    """``(pad, m_h, m_w)`` of the K1 launch of one level."""
    if mode == "periodization":
        return L // 2 - 1, h // 2, w // 2
    pad = (2 * L - 3) // 2
    return pad, (h + 2 * pad - L) // 2 + 1, (w + 2 * pad - L) // 2 + 1


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


# (shape, bank, mode): the periodic headline's level 1 (m = 515: a 3-row
# last tile row and column), periodization, a ragged 384 x 768 image, a
# long bank and an odd one
CASES = [
    ((1, 1024, 1024), "db4", "periodic"),
    ((1, 1024, 1024), "db4", "periodization"),
    ((2, 384, 768), "db4", "periodic"),
    ((1, 384, 768), "sym6", "periodization"),
    ((1, 384, 768), "sym6", "periodic"),
    ((1, 256, 512), "db20", "periodic"),
    ((1, 128, 256), "haar", "periodization"),
    ((1, 384, 768), "odd7", "periodic"),
]


def case_params(indices):
    """``CASES[i]`` with the ids pytest gives them in a parametrisation over
    all of them: the slow replays run in files of their own
    (``test_torch_mxu2d_tiles_*.py``), so that the test run spreads them
    over its workers, and keep their ids."""
    return pytest.mark.parametrize(
        "shape,bank,mode", [CASES[i] for i in indices],
        ids=[f"shape{i}-{CASES[i][1]}-{CASES[i][2]}" for i in indices],
    )


@case_params([0, 6])
def test_replay_matches_plain(shape, bank, mode):
    check_replay(shape, bank, mode)


def check_replay(shape, bank, mode):
    """K9a, K9b and both VJP instances, each launch against its plain
    version (1e-12), and in float64 the adjoint identity of each pair."""
    lo, hi, rlo, rhi = _bank(bank)
    b, h, w = shape
    L = len(lo)
    pad, m_h, m_w = _geometry(h, w, L, mode)
    circular = mode == "periodization"
    rs = np.random.RandomState(81)
    x = rs.randn(*shape)
    paths = _paths()
    # K9a, the level's analysis
    got = replay_analysis(x, lo, hi, h, w, m_h, m_w, pad, True, paths=paths)
    want = t9.mxu2_dwt_plain(torch.from_numpy(x), lo, hi, h, w, m_h, m_w, pad).numpy()
    assert _rel(got, want) <= TOL
    # K9b, the level's synthesis (the crop folded in for periodic)
    bands = [rs.randn(b, m_h, m_w) for _ in range(4)]
    rec = replay_synthesis(bands, rlo, rhi, h, w, pad, circular, paths=paths)
    ref = t9.mxu2_idwt_plain([torch.from_numpy(t) for t in bands], rlo, rhi, h, w, pad, circular).numpy()
    assert _rel(rec, ref) <= TOL
    # K9a's VJP: K9b with the dec taps, folding the band rows past half
    fold = (h // 2, w // 2, h, w)
    grad = replay_synthesis(bands, lo, hi, h, w, pad, True, fold, paths=paths)
    ref = t9.mxu2_idwt_plain([torch.from_numpy(t) for t in bands], lo, hi, h, w, pad, True, fold).numpy()
    assert _rel(grad, ref) <= TOL
    # K9b's VJP: K9a with the rec taps, zero-bounded for periodic
    ct = rs.randn(*shape)
    grads = replay_analysis(ct, rlo, rhi, h, w, m_h, m_w, pad, circular, paths=paths)
    ref = t9.mxu2_dwt_plain(torch.from_numpy(ct), rlo, rhi, h, w, m_h, m_w, pad, circular).numpy()
    assert _rel(grads, ref) <= TOL
    # the adjoint identity: <K9a x, y> = <x, K9a^T y>, <K9b y, z> = <y, K9b^T z>
    lhs, rhs = np.vdot(got, np.stack(bands)), np.vdot(x, grad)
    assert abs(lhs - rhs) <= TOL * np.linalg.norm(got) * np.linalg.norm(np.stack(bands))
    lhs, rhs = np.vdot(rec, ct), np.vdot(np.stack(bands), grads)
    assert abs(lhs - rhs) <= TOL * np.linalg.norm(rec) * np.linalg.norm(ct)
    # interior windows stage whole; the element copies run off every
    # image's edge; periodic's zero-bounded instances (K9b, K9b's VJP) stage
    # zero rows
    assert paths["inside"] and paths["vector"] and paths["element"]
    assert bool(paths["zero"]) == (mode == "periodic")


def test_odd_bank_periodization_stays_off_k9(monkeypatch):
    """K9 takes a K1 level's arguments; an odd bank in periodization no
    longer reaches K1 (its bands are period / 2 - 1 long), so K9's gate is
    never asked; in periodic (above) the replay matches the plain version."""
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    assert t9.mxu2_level_ok(256, 512, 7, torch.float32)
    assert not t2d.fused2_analysis_applicable(256, 512, 7, "periodization")
    assert t2d.fused2_analysis_applicable(256, 512, 7, "periodic")


@pytest.mark.parametrize("step,n,limit", [(256, 18, 144), (256, 7, 3), (256, 300, 2), (256, 1, 40)])
def test_walk_takes_every_item_once(step, n, limit):
    """``Walk`` of ``csrc/mxu2d.cu``: the threads of a block of ``step``
    step through ``[limit, n]`` items without division, each item once."""
    seen = []
    for tid in range(step):
        outer, inner = divmod(tid, n)
        d_outer, d_inner = divmod(step, n)
        while outer < limit:
            seen.append(outer * n + inner)
            outer, inner = outer + d_outer, inner + d_inner
            if inner >= n:
                inner, outer = inner - n, outer + 1
    assert sorted(seen) == list(range(limit * n))


def test_plans_fit_and_cover():
    """Every length K9 takes, both pads: plans whose tables, ring and pass
    buffer fit a block, and whose windows cover every read (the
    conditions ``csrc/mxu2d.cu`` checks)."""
    for L in range(2, t9.MAX_TAPS + 1):
        for pad in (L // 2 - 1, (2 * L - 3) // 2):
            plan = t9.analysis_plan(L, pad, 515, 515)
            tm, tn, off, kw, kh, xrows, xcols, sx, sy, _, _, xbuf, stages = plan
            assert 8 * kw >= off + 14 + L and 8 * kh >= 14 + L and off == -pad % 4
            assert tm % 8 == 0 and tn % 16 == 0 and xrows % 16 == 0
            assert xrows >= 2 * tm - 16 + 8 * kh and xcols >= 2 * tn - 16 + 8 * kw
            assert sx % 8 == 4 and sy % 16 == 4 and xbuf == xrows * sx and stages in (2, 3)
            assert t9.analysis_smem(plan) <= t9.SMEM_LIMIT
            plan = t9.synthesis_plan(L, pad, pad, 515, 515, 1024, 1024)
            tu, tv, _, _, e_h, e_w, o, base, ks, kw, brows, bcols, sb, st, _, _, bbuf, stages = plan
            assert e_h in (L - 1, L) and e_w in (L - 1, L) and tu % 8 == 0 and tv % 16 == 0
            # output columns [0, 8) read window columns o + ceil((e - L + 1) / 2) .. o + (7 + e) // 2
            assert base <= o + -((L - 1 - e_w) // 2) and base + 8 * kw > o + (7 + e_w) // 2
            assert 8 * ks > (7 + e_h) // 2 and brows >= tu // 2 - 4 + 8 * ks
            assert sb % 8 == 4 and st % 16 == 4 and bbuf == 4 * brows * sb and stages in (2, 3)
            # the fold of K9a's VJP: windows narrower than half the period
            assert brows <= 512 and bcols <= 512
            assert t9.synthesis_smem(plan) <= t9.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the glue on the replay, against the JAX package's K9 (interpret mode)
# ---------------------------------------------------------------------------


def _replay_launch(kernel, entry, device, dtype, *a):
    """``_kernels.launch`` with K9 replayed and the others on the numpy
    model of ``tests/test_torch_kernels.py``."""
    if entry == "ptwt_mxu2d_analysis":
        x, out, lo, hi, L, _, _, _, per_h, per_w, m_h, m_w, pad, circ, plan, plan_len = a
        assert list(plan)[:plan_len] == list(t9.analysis_plan(L, pad, m_h, m_w))
        res = replay_analysis(x.double().numpy(), list(lo)[:L], list(hi)[:L], per_h, per_w,
                              m_h, m_w, pad, bool(circ))
        out.copy_(torch.from_numpy(res))
    elif entry == "ptwt_mxu2d_synthesis":
        *bands, out, lo, hi, L, _, m_h, m_w, out_h, out_w, off_h, off_w, circ = a[:16]
        fold, (plan, plan_len) = a[16:20], a[20:]
        assert off_h == off_w
        assert list(plan)[:plan_len] == list(t9.synthesis_plan(L, off_h, off_w, m_h, m_w, out_h, out_w))
        res = replay_synthesis([t.double().numpy() for t in bands], list(lo)[:L], list(hi)[:L],
                               out_h, out_w, off_h, bool(circ), tuple(fold))
        out.copy_(torch.from_numpy(res))
    else:
        return _model_launch(kernel, entry, device, dtype, *a)
    _kernels.LAUNCHES[kernel] += 1


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    monkeypatch.setattr(_kernels, "launch", _replay_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    for module in (t2, t2d):
        monkeypatch.setattr(module, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


# an odd bank in periodization runs K3/K4, not K9
# (test_odd_bank_periodization_stays_off_k9)
@pytest.mark.parametrize("bank,mode", [("db4", "periodic"), ("db4", "periodization"), ("odd7", "periodic")])
def test_glue_on_the_replay_matches_jax(replay, bank, mode):
    """One level each way and its gradient through the glue, float32,
    against the JAX K9 in interpret mode and ``jax.vjp`` through the JAX
    package's ``_level_calls`` (5e-5 and 5e-4, as
    ``tests/test_torch_mxu2d.py``); the odd bank against the JAX per-axis
    route, since the JAX level kernels take even banks only."""
    dl, dh, rl, rh = (np.asarray(f, np.float32) for f in _bank(bank))
    x = np.random.RandomState(82).randn(1, 256, 512).astype(np.float32)
    if bank == "odd7":
        # the JAX K1/K2 level takes even banks only: its per-axis route
        crop = (2 * len(dl) - 3) // 2

        def ref_dwt(inp):
            return j_analysis_nd(inp, dl, dh, mode=mode, ndim=2)

        def ref_idwt(bands):
            return j_synthesis_nd(bands, rl, rh, pads=[(crop, crop)] * 2, mode=mode, ndim=2)

    else:

        def ref_dwt(inp):
            return j2d.fused2_dwt_level(inp, dl, dh, mode)

        def ref_idwt(bands):
            return j2d.fused2_idwt_level(bands, rl, rh, mode)

    want = ref_dwt(jnp.asarray(x))
    got = t2d.fused2_dwt_level(torch.from_numpy(x), dl, dh, mode)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=5e-5, rtol=0)
    rec = t2d.fused2_idwt_level(list(got), rl, rh, mode)
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_idwt(want)), atol=5e-5, rtol=0)

    def loss_jax(inp):
        bands = ref_dwt(inp)
        out = ref_idwt(bands)
        return jnp.sum(out**2) + sum(jnp.sum(jnp.cos(b)) for b in bands)

    grad_want = jax.grad(loss_jax)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    bands = t2d.fused2_dwt_level(xt, dl, dh, mode)
    out = t2d.fused2_idwt_level(bands, rl, rh, mode)
    loss = (out**2).sum() + sum(torch.cos(b).sum() for b in bands)
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_want), atol=5e-4, rtol=0)
    # forward: K9a, K9b, K9a, K9b; backward: K9b's VJP (K9a), K9a's (K9b);
    # the odd bank's synthesis writes 255 x 511, which K9's gate leaves to
    # K2 (and its VJP to K1)
    launches = {k: v for k, v in replay.items() if v}
    if bank == "odd7":
        assert launches == {"K9a": 2, "K9b": 1, "K2": 2, "K1": 1}
    else:
        assert launches == {"K9a": 3, "K9b": 3}
