"""K5a/K5b's tiles (``csrc/pyramid2d.cu``) replayed block by block in numpy.

The replay runs each launch as the kernels do: the plan's tiles, the
cone (analysis) or band ranges (synthesis) staged into a model of the
block's shared memory at the kernel's offsets and strides (16-byte
segments where the row segment lies inside the image, element copies with
the wrap only where a window crosses the image's edge), the four-output
sliding windows of the H and W passes read from there, and the copy-out of
the positions a tile owns.  Shared memory starts as NaN, so a kept output
that read a position no copy or pass wrote comes out NaN and fails; every
index must lie inside the launch's two regions, whose sizes must hold the
layout (``_analysis_need``/``_synthesis_need``) within the launch's
reservation; every band position or output is written exactly once.

The glue (``ops/_pallas.py``) runs on the replay against the JAX package's
K5 in Pallas interpret mode (float32, within 3e-6, as
``tests/test_torch_pyramid2d.py`` calls it) and ``jax.vjp`` through it,
against ``ptwt_tpu.wavedec2``/``waverec2`` in ``periodization`` in float64
(1e-10) where the JAX kernel does not reach (ragged tiles, coif17 on a
small image, db20), and every launch against the plain versions (1e-12).
The float64 adjoint identity holds within 1e-12 of ``|Kx||y|``.  The plan
accepts every shape the previous plan accepted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _banks, _model_launch, _model_pyramid2d_analysis, _model_pyramid2d_synthesis

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu.ops import _pallas as j5
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t5
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL32 = 3e-6


def _mod(p, m):
    return np.mod(p, m)


class _Smem:
    """A block's shared memory, ``[batch, buf_a + buf_b]``, NaN at start;
    every access is checked against its region."""

    def __init__(self, batch, buf_a, buf_b):
        self.a, self.b = buf_a, buf_b
        self.mem = np.full((batch, buf_a + buf_b), np.nan)

    def _idx(self, region, idx):
        idx = np.asarray(idx)
        size = self.a if region == "A" else self.b
        assert idx.size == 0 or (idx.min() >= 0 and idx.max() < size), f"outside region {region}"
        return idx + (0 if region == "A" else self.a)

    def read(self, region, idx):
        return self.mem[:, self._idx(region, idx)]

    def write(self, region, idx, vals):
        self.mem[:, self._idx(region, idx)] = vals


def _stage(smem, dst, stride, src, r0, nr, c0, nc, mh, mw, vec_elems, stats):
    """``stage_block``: rows of [c0, c0 + nc) modulo the band, at offset
    ``o = c0 mod V``; 16-byte segments where the segment lies inside."""
    o = c0 % vec_elems
    rows = np.arange(r0, r0 + nr)
    wrapped = (rows < 0) | (rows >= mh)
    rows = np.where(wrapped, _mod(rows, mh), rows)
    if c0 >= 0 and c0 + nc <= mw and mw % vec_elems == 0:
        chunks = (o + nc + vec_elems - 1) // vec_elems
        cols = c0 - o + np.arange(chunks * vec_elems)
        assert cols[-1] < mw and (c0 - o) % vec_elems == 0
        dst_cols = np.arange(chunks * vec_elems)
        stats["vec"] += 1
    else:
        cols = c0 + np.arange(nc)
        out = (cols < 0) | (cols >= mw)
        cols = np.where(out, _mod(cols, mw), cols)
        dst_cols = o + np.arange(nc)
        stats["elem"] += 1
    idx = dst + np.arange(nr)[:, None] * stride + dst_cols[None, :]
    smem.write("A", idx.ravel(), src[:, rows[:, None], cols[None, :]].reshape(src.shape[0], -1))
    return o


def _analysis_windows(smem, region, base, stride, starts, n_wrap, taps_lo, taps_hi, half):
    """``analysis_line`` for many items: ``base`` and ``starts`` are item
    arrays; returns ``lo``, ``hi`` of shape [batch, items, 4]."""
    j = np.arange(2 * half + 6)
    pos = starts[:, None] + j[None, :]
    if n_wrap:
        pos = _mod(pos, n_wrap)
    vals = smem.read(region, (base[:, None] + pos * stride).ravel()).reshape(-1, len(starts), len(j))
    tl = np.asarray(taps_lo[: 2 * half])
    th = np.asarray(taps_hi[: 2 * half])
    lo = np.stack([vals[:, :, 2 * r : 2 * r + 2 * half] @ tl for r in range(4)], axis=-1)
    hi = np.stack([vals[:, :, 2 * r : 2 * r + 2 * half] @ th for r in range(4)], axis=-1)
    return lo, hi


def _taps(t, n_taps):
    """The kernel-parameter bank: taps, then zeros up to 128."""
    out = np.zeros(128)
    out[:n_taps] = t[:n_taps]
    return out


def replay_analysis(x, ll_out, det, lo, hi, n_taps, batch, plan, smem_bytes, itemsize, stats=None):
    """``ptwt_pyramid2d_analysis`` block by block."""
    depth, h, w, th, tw, tiles_h, tiles_w, whole, pad, buf_a, buf_b, bufs = list(plan)
    need = t5._analysis_need(depth, h, w, th, tw, whole, n_taps, itemsize)
    assert buf_a >= need[0] and buf_b >= need[1] and buf_a % 4 == 0
    assert bufs in (1, 2) and (bufs * buf_a + buf_b) * itemsize <= smem_bytes <= t5._SMEM_LIMIT
    assert pad == n_taps // 2 - 1 and (whole or (depth <= t5.MAX_TILED_DEPTH and bufs == 1))
    stats = stats if stats is not None else {"vec": 0, "elem": 0}
    v = 16 // itemsize
    le = n_taps + (n_taps & 1)
    half = le // 2
    tl, tg = _taps(lo, n_taps), _taps(hi, n_taps)
    xs = x.numpy().reshape(batch, h, w).astype(np.float64)
    bands = [[np.full((batch, h >> lv, w >> lv), np.nan) for _ in range(3)] for lv in range(depth + 1)]
    ll_d = np.full((batch, h >> depth, w >> depth), np.nan)
    for ty in range(tiles_h):
        for tx in range(tiles_w):
            sm = _Smem(batch, buf_a, buf_b)
            sh, ch, sw, cw = [0] * (depth + 1), [0] * (depth + 1), [0] * (depth + 1), [0] * (depth + 1)
            sh[depth], sw[depth] = (0, 0) if whole else (ty * th, tx * tw)
            ch[depth], cw[depth] = th, tw
            for lv in range(depth, 0, -1):
                if whole:
                    sh[lv - 1], sw[lv - 1], ch[lv - 1], cw[lv - 1] = 0, 0, h >> (lv - 1), w >> (lv - 1)
                else:
                    sh[lv - 1], sw[lv - 1] = 2 * sh[lv] - pad, 2 * sw[lv] - pad
                    ch[lv - 1], cw[lv - 1] = 2 * ch[lv] + le - 2, 2 * cw[lv] + le - 2
            s0 = t5._round(cw[0] + v - 1, v)
            o0 = _stage(sm, 0, s0, xs, sh[0], ch[0], sw[0], cw[0], h, w, v, stats)
            for lv in range(1, depth + 1):
                bh, bw = h >> (lv - 1), w >> (lv - 1)
                mh, mw = bh >> 1, bw >> 1
                s_in = s0 if lv == 1 else t5._round(cw[lv - 1], 4) + 1
                o_in = o0 if lv == 1 else 0
                s1 = t5._reach(cw[lv], cw[lv - 1], le, whole) | 1
                # H pass
                groups, cols = (ch[lv] + 3) // 4, cw[lv - 1]
                g, c = np.divmod(np.arange(groups * cols), cols)
                starts = 8 * g - (pad if whole else 0)
                lo_h, hi_h = _analysis_windows(sm, "A", o_in + c, s_in, starts, bh if whole else 0, tl, tg, half)
                for r in range(4):
                    keep = 4 * g + r < ch[lv]
                    sm.write("B", ((4 * g + r) * s1 + c)[keep], lo_h[:, keep, r])
                    sm.write("B", (ch[lv] * s1 + (4 * g + r) * s1 + c)[keep], hi_h[:, keep, r])
                # W pass
                sb = t5._round(cw[lv], 4) + 1
                rows_ll = t5._reach(ch[lv + 1], ch[lv], le, whole) if lv < depth else ch[lv]
                det_at = rows_ll * sb
                quads = (cw[lv] + 3) // 4
                per_half = ch[lv] * quads
                idx = np.arange(2 * per_half)
                hf = (idx >= per_half).astype(int)
                g, r = np.divmod(idx - hf * per_half, ch[lv])
                starts = 8 * g - (pad if whole else 0)
                lo_w, hi_w = _analysis_windows(sm, "B", hf * ch[lv] * s1 + r * s1, 1, starts, bw if whole else 0, tl, tg, half)
                for q in range(4):
                    sm.write("A", np.where(hf, det_at, 0) + r * sb + 4 * g + q, lo_w[:, :, q])
                    sm.write("A", det_at + np.where(hf, 2, 1) * ch[lv] * sb + r * sb + 4 * g + q, hi_w[:, :, q])
                # the owned positions
                own_h, own_w = th << (depth - lv), tw << (depth - lv)
                fh, fw = (0, 0) if whole else (ty * own_h, tx * own_w)
                nh, nw = min(fh + own_h, mh) - fh, min(fw + own_w, mw) - fw
                rh, rw = fh - sh[lv], fw - sw[lv]
                assert rh >= 0 and rw >= 0 and rh + nh <= ch[lv] and rw + nw <= cw[lv]
                targets = [*bands[lv], ll_d] if lv == depth else bands[lv]
                for bi, band in enumerate(targets):
                    at = det_at + bi * ch[lv] * sb if bi < 3 else 0
                    src = at + (rh + np.arange(nh))[:, None] * sb + rw + np.arange(nw)[None, :]
                    vals = sm.read("A", src.ravel()).reshape(batch, nh, nw)
                    assert np.isfinite(vals).all(), "a kept output read a position nothing wrote"
                    block = band[:, fh : fh + nh, fw : fw + nw]
                    assert np.isnan(block).all(), "a band position was written twice"
                    band[:, fh : fh + nh, fw : fw + nw] = vals
    outs = [ll_d] + [band for lv in range(1, depth + 1) for band in bands[lv]]
    for t, band in zip([ll_out, *det], outs):
        assert not np.isnan(band).any(), "a band position was never written"
        t.copy_(torch.from_numpy(band).reshape(t.shape))
    assert all(t is None for t in det[3 * depth :])


def _synthesis_windows(smem, region_a, base_a, sa, region_b, base_b, sb, q, n_wrap, ta, tb, half):
    """``synthesis_line`` for many items: [batch, items, 4] even and odd
    outputs of four pairs."""
    ev, od = [], []
    for r in range(4):
        pos = q[:, None] + r - np.arange(half)[None, :]
        if n_wrap:
            pos = _mod(pos, n_wrap)
        assert n_wrap or pos.min() >= 0
        a = smem.read(region_a, (base_a[:, None] + pos * sa).ravel()).reshape(-1, len(q), half)
        b = smem.read(region_b, (base_b[:, None] + pos * sb).ravel()).reshape(-1, len(q), half)
        ev.append(a @ ta[0 : 2 * half : 2] + b @ tb[0 : 2 * half : 2])
        od.append(a @ ta[1 : 2 * half : 2] + b @ tb[1 : 2 * half : 2])
    return np.stack(ev, axis=-1), np.stack(od, axis=-1)


def replay_synthesis(ll_in, det, out, lo, hi, n_taps, batch, plan, smem_bytes, itemsize, stats=None):
    """``ptwt_pyramid2d_synthesis`` block by block."""
    depth, h, w, th, tw, tiles_h, tiles_w, whole, pad, buf_a, buf_b, bufs = list(plan)
    need = t5._synthesis_need(depth, h, w, th, tw, whole, n_taps, itemsize)
    assert buf_a >= need[0] and buf_b >= need[1] and buf_a % 4 == 0
    assert bufs in (1, 2) and (bufs * buf_a + buf_b) * itemsize <= smem_bytes <= t5._SMEM_LIMIT
    assert pad == n_taps // 2 - 1 and (whole or (depth <= t5.MAX_TILED_DEPTH and bufs == 1))
    stats = stats if stats is not None else {"vec": 0, "elem": 0}
    v = 16 // itemsize
    half = (n_taps + 1) // 2
    tl, tg = _taps(lo, n_taps), _taps(hi, n_taps)
    ll_d = ll_in.numpy().reshape(batch, h >> depth, w >> depth).astype(np.float64)
    dets = [[det[3 * (lv - 1) + o].numpy().reshape(batch, h >> lv, w >> lv) for o in range(3)]
            for lv in range(1, depth + 1)]
    result = np.full((batch, h, w), np.nan)
    alloc = functools.partial(t5._alloc_at, filt_len=n_taps, whole=bool(whole))
    span = functools.partial(t5._span_at, filt_len=n_taps, whole=bool(whole))

    def band_elems(lv):
        return alloc(th, h, lvl=lv) * t5._round(alloc(tw, w, lvl=lv) + v - 1, v)

    def details_at(lv):
        return band_elems(depth) + 3 * sum(band_elems(m) for m in range(lv + 1, depth + 1))

    ll_elems = alloc(th, h, lvl=1) * (alloc(tw, w, lvl=1) | 1) if depth > 1 else 0
    for ty in range(tiles_h):
        for tx in range(tiles_w):
            sm = _Smem(batch, buf_a, buf_b)
            ch, cw = [0 if whole else ty * th], [0 if whole else tx * tw]
            nh, nw = [th], [tw]
            eh, ew = ch[0] + th - 1, cw[0] + tw - 1
            for lv in range(1, depth + 1):
                if whole:
                    ch.append(0), cw.append(0), nh.append(h >> lv), nw.append(w >> lv)
                else:
                    ch.append((ch[-1] + pad - (n_taps - 1)) // 2)
                    cw.append((cw[-1] + pad - (n_taps - 1)) // 2)
                    eh, ew = (eh + pad) // 2, (ew + pad) // 2
                    nh.append(eh - ch[-1] + 1), nw.append(ew - cw[-1] + 1)
                assert nh[lv] <= span(th, h, lvl=lv) and nw[lv] <= span(tw, w, lvl=lv)
            offs = {}
            for lv in range(depth, 0, -1):
                mh, mw = h >> lv, w >> lv
                sbd = t5._round(alloc(tw, w, lvl=lv) + v - 1, v)
                srcs = ([(0, ll_d)] if lv == depth else []) + [
                    (details_at(lv) + o * band_elems(lv), dets[lv - 1][o]) for o in range(3)
                ]
                for at, src in srcs:
                    offs[lv] = _stage(sm, at, sbd, src, ch[lv], nh[lv], cw[lv], nw[lv], mh, mw, v, stats)
            for lv in range(depth, 0, -1):
                mh, mw = h >> lv, w >> lv
                o_l = offs[lv]
                aw = alloc(tw, w, lvl=lv)
                sbd = t5._round(aw + v - 1, v)
                bs = band_elems(lv)
                ll_region, ll_at, s_ll = ("A", o_l, sbd) if lv == depth else ("B", 0, aw | 1)
                lh_at = details_at(lv) + o_l
                s2 = aw | 1
                low = ll_elems
                hiw = low + span(th, h, lvl=lv - 1) * s2
                # H pass
                par = (ch[lv - 1] + pad) & 1
                q0 = ((ch[lv - 1] + pad - par) >> 1) - ch[lv]
                groups = (((nh[lv - 1] + par + 1) >> 1) + 3) >> 2
                per_half = groups * nw[lv]
                for hf in (0, 1):
                    g, j = np.divmod(np.arange(per_half), nw[lv])
                    q = q0 + 4 * g
                    if hf:
                        ev, od = _synthesis_windows(sm, "A", lh_at + bs + j, sbd, "A", lh_at + 2 * bs + j, sbd,
                                                    q, mh if whole else 0, tl, tg, half)
                    else:
                        ev, od = _synthesis_windows(sm, ll_region, ll_at + j, s_ll, "A", lh_at + j, sbd,
                                                    q, mh if whole else 0, tl, tg, half)
                    dst = (hiw if hf else low) + j
                    for r in range(4):
                        t = 2 * (4 * g + r) - par
                        keep = (t >= 0) & (t < nh[lv - 1])
                        sm.write("B", (dst + t * s2)[keep], ev[:, keep, r])
                        keep = t + 1 < nh[lv - 1]
                        sm.write("B", (dst + (t + 1) * s2)[keep], od[:, keep, r])
                # W pass
                par = (cw[lv - 1] + pad) & 1
                q0 = ((cw[lv - 1] + pad - par) >> 1) - cw[lv]
                groups = (((nw[lv - 1] + par + 1) >> 1) + 3) >> 2
                region = "B" if lv > 1 else "A"
                sd = (alloc(tw, w, lvl=lv - 1) | 1) if lv > 1 else (span(tw, w, lvl=0) | 1)
                g, t = np.divmod(np.arange(nh[lv - 1] * groups), nh[lv - 1])
                ev, od = _synthesis_windows(sm, "B", low + t * s2, 1, "B", hiw + t * s2, 1,
                                            q0 + 4 * g, mw if whole else 0, tl, tg, half)
                for r in range(4):
                    u = 2 * (4 * g + r) - par
                    keep = (u >= 0) & (u < nw[lv - 1])
                    sm.write(region, (t * sd + u)[keep], ev[:, keep, r])
                    keep = u + 1 < nw[lv - 1]
                    sm.write(region, (t * sd + u + 1)[keep], od[:, keep, r])
            sd = span(tw, w, lvl=0) | 1
            rows, cols = min(nh[0], h - ch[0]), min(nw[0], w - cw[0])
            vals = sm.read("A", (np.arange(rows)[:, None] * sd + np.arange(cols)[None, :]).ravel())
            vals = vals.reshape(batch, rows, cols)
            assert np.isfinite(vals).all(), "a kept output read a position nothing wrote"
            block = result[:, ch[0] : ch[0] + rows, cw[0] : cw[0] + cols]
            assert np.isnan(block).all(), "an output was written twice"
            result[:, ch[0] : ch[0] + rows, cw[0] : cw[0] + cols] = vals
    assert not np.isnan(result).any(), "an output was never written"
    out.copy_(torch.from_numpy(result).reshape(out.shape))


#: Staging paths taken by the replayed launches of a test.
STATS = {"vec": 0, "elem": 0}


def _replay_launch(kernel, entry, device, dtype, *a):
    """``_kernels.launch`` with the pyramid entries replayed block by block
    (every other entry on the model of ``tests/test_torch_kernels.py``)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if entry == "ptwt_pyramid2d_analysis":
        replay_analysis(*a, itemsize, STATS)
    elif entry == "ptwt_pyramid2d_synthesis":
        replay_synthesis(*a, itemsize, STATS)
    else:
        return _model_launch(kernel, entry, device, dtype, *a)
    _kernels.LAUNCHES[kernel] += 1


@pytest.fixture
def replay(monkeypatch):
    """Send CPU tensors down the CUDA glue onto the replay."""
    from ptwt_tpu_torch.ops import _pallas2, _pallas2d

    monkeypatch.setattr(_kernels, "launch", _replay_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    for module in (t5, _pallas2, _pallas2d):
        monkeypatch.setattr(module, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()
    STATS.update(vec=0, elem=0)
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


def _flat(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


def _nest(flat, level):
    return [flat[0]] + [tuple(flat[1 + 3 * i : 4 + 3 * i]) for i in range(level)]


def _close(got, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# every launch against the plain versions (float64)
# ---------------------------------------------------------------------------

# (shape, wavelet, level): whole images (square, odd sizes, long banks),
# tiled runs (square, ragged, odd tile counts), an odd bank
LAUNCHES = [
    ((2, 64, 64), "db4", 2),
    ((1, 96, 160), "db4", 5),  # ragged tiles, not a power of two, then a whole image
    ((1, 24, 20), "coif17", 2),  # 102 taps on a small image: a whole image
    ((1, 128, 64), "db20", 2),  # 40 taps
    ((2, 48, 40), "haar", 3),
    ((1, 40, 24), "sym5", 3),  # not a multiple of four along W
    ((2, 128, 128), "db4", 2),  # square tiles, then a whole image
    ((1, 144, 120), "haar", 3),  # nine tile rows of 8 x 60
    ((1, 160, 88), "sym5", 3),  # tiles of 8 x 44, a 10-tap odd-half bank
]


@pytest.mark.parametrize("shape,wavelet,level", LAUNCHES)
def test_launches_match_plain(replay, shape, wavelet, level):
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape))
    got = t5.fused_wavedec2d_per(x, dl, dh, level)
    with torch.no_grad():
        want = t5.wavedec2d_per_plain(x, dl, dh, level)
    for g, w_ in zip(_flat(got), _flat(want)):
        _close(g, w_.numpy(), 1e-12)
    rec = t5.fused_waverec2d_per(want, rl, rh)
    _close(rec, t5.waverec2d_per_plain(want, rl, rh).numpy(), 1e-12)
    _close(rec, x.numpy(), 1e-10)
    runs = t5._plan_runs(*shape[1:], len(dl), level, torch.float64)
    assert replay["K5a"] == replay["K5b"] == len(runs)


@pytest.mark.parametrize("whole", [False, True])
def test_odd_bank_reads_its_zero_tap_inside_the_cone(whole):
    """An odd-length bank: the cones and windows run over L + 1 taps, the
    last one zero, and every value read lies inside the staged data; both
    launches compute what the kernel model of ``tests/test_torch_kernels.py``
    computes (the plain versions give odd banks other band sizes)."""
    lo, hi = np.random.RandomState(2).randn(2, 7)
    depth, h, w = (2, 64, 64) if whole else (1, 64, 64)  # tiled runs are one level deep
    th, tw = (h >> depth, w >> depth) if whole else t5._analysis_tile(h, w, 7, 8, t5._SMEM_LIMIT, None)
    a, b = t5._analysis_need(depth, h, w, th, tw, whole, 7, 8)
    ints = (depth, h, w, th, tw, -(-(h >> depth) // th), -(-(w >> depth) // tw), int(whole), 2, a, b, 1)
    x = torch.from_numpy(np.random.RandomState(3).randn(1, h, w))

    def bands():
        return torch.empty(1, h >> depth, w >> depth), [
            torch.empty(1, h >> lv, w >> lv) for lv in range(1, depth + 1) for _ in range(3)
        ]

    (ll, det), (ll_m, det_m) = bands(), bands()
    none = [None] * (24 - 3 * depth)
    replay_analysis(x, ll, det + none, lo, hi, 7, 1, ints, (a + b) * 8, 8)
    _model_pyramid2d_analysis(x, ll_m, det_m + none, lo, hi, 7, 1, ints, (a + b) * 8, 8)
    for g, w_ in zip([ll, *det], [ll_m, *det_m]):
        _close(g, w_.numpy(), 1e-12)
    th, tw = (h, w) if whole else (32, 32)
    a, b = t5._synthesis_need(depth, h, w, th, tw, whole, 7, 8)
    ints = (depth, h, w, th, tw, -(-h // th), -(-w // tw), int(whole), 2, a, b, 1)
    out, out_m = torch.empty(1, h, w), torch.empty(1, h, w)
    replay_synthesis(ll, det + none, out, lo, hi, 7, 1, ints, (a + b) * 8, 8)
    _model_pyramid2d_synthesis(ll, det + none, out_m, lo, hi, 7, 1, ints, (a + b) * 8, 8)
    _close(out, out_m.numpy(), 1e-12)


def test_staging_takes_16_byte_segments_inside_the_image():
    """Interior rows go as 16-byte segments; only windows that cross the
    image's left or right edge (or rows not a multiple of 16 bytes) go
    element by element, and rows wrap one by one."""
    lo, hi, _, _ = _banks("db4", np.float32)
    depth, h, w, th, tw = 1, 256, 256, 16, 16
    a, b = t5._analysis_need(depth, h, w, th, tw, False, 8, 4)
    ints = (depth, h, w, th, tw, 8, 8, 0, 3, a, b, 1)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, h, w).astype(np.float32))
    ll = torch.empty(1, h >> depth, w >> depth)
    det = [torch.empty(1, h >> 1, w >> 1) for _ in range(3)] + [None] * 21
    stats = {"vec": 0, "elem": 0}
    replay_analysis(x, ll, det, lo, hi, 8, 1, ints, (a + b) * 4, 4, stats)
    # 8 x 8 tiles: the 48 of the six inner tile columns stage by segments,
    # the 16 whose window crosses the left or right edge element by element
    assert stats == {"vec": 48, "elem": 16}
    with torch.no_grad():
        want = t5.wavedec2d_per_plain(x.double(), lo.astype(np.float64), hi.astype(np.float64), depth)
    _close(ll, want[0].numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the glue on the replay against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet", ["haar", "db4"])
@pytest.mark.parametrize("h,w,level", [(64, 256, 2), (128, 128, 3)])
def test_replay_matches_jax_kernel(replay, wavelet, h, w, level):
    """The JAX K5 in interpret mode, called as ``tests/test_pallas.py``
    calls it (float32)."""
    dl, dh, rl, rh = _banks(wavelet)
    x = np.random.RandomState(5).randn(2, h, w).astype(np.float32)
    want = j5.fused_wavedec2d_per(jnp.asarray(x), dl, dh, level)
    got = t5.fused_wavedec2d_per(torch.from_numpy(x), dl, dh, level)
    for g, w_ in zip(_flat(got), jax.tree.leaves(tuple(want))):
        _close(g, w_, TOL32)
    bands = [torch.from_numpy(np.array(w_)) for w_ in jax.tree.leaves(tuple(want))]
    rec = t5.fused_waverec2d_per(_nest(bands, level), rl, rh)
    _close(rec, j5.fused_waverec2d_per(want, rl, rh), TOL32)


def test_replay_vjps_match_jax_vjp(replay):
    """K5a's VJP (a K5b launch) and K5b's (a K5a launch) against ``jax.vjp``
    through the JAX K5 pair (float32)."""
    dl, dh, rl, rh = _banks("db4")
    level = 2
    x = np.random.RandomState(6).randn(1, 64, 128).astype(np.float32)
    want, vjp = jax.vjp(lambda t: tuple(jax.tree.leaves(tuple(j5.fused_wavedec2d_per(t, dl, dh, level)))), jnp.asarray(x))
    cts = [np.random.RandomState(7 + i).randn(*np.shape(w_)).astype(np.float32) for i, w_ in enumerate(want)]
    xt = torch.from_numpy(x).requires_grad_()
    got = _flat(t5.fused_wavedec2d_per(xt, dl, dh, level))
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(got, xt, [torch.from_numpy(c) for c in cts])
    _close(grad, vjp(tuple(jnp.asarray(c) for c in cts))[0], 2e-5)
    assert {k for k, v in replay.items() if v} == {"K5b"}

    packed = tuple(jnp.asarray(w_) for w_ in want)
    rec, rvjp = jax.vjp(lambda *c: j5.fused_waverec2d_per(_nest(list(c), level), rl, rh), *packed)
    ct = np.random.RandomState(20).randn(*rec.shape).astype(np.float32)
    leaves = [torch.from_numpy(np.array(c)).requires_grad_() for c in packed]
    out = t5.fused_waverec2d_per(_nest(leaves, level), rl, rh)
    _kernels.reset_launch_counts()
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for g, w_ in zip(grads, rvjp(jnp.asarray(ct))):
        _close(g, w_, 2e-5)
    assert {k for k, v in replay.items() if v} == {"K5a"}


# outside the JAX kernel's domain: ragged tiles, coif17 on a small image, db20
PUBLIC = [((1, 96, 160), "db4", 5), ((1, 24, 20), "coif17", 2), ((1, 128, 64), "db20", 2)]


@pytest.mark.parametrize("shape,wavelet,level", PUBLIC)
def test_public_path_on_the_replay_matches_ptwt_tpu(replay, shape, wavelet, level):
    """``wavedec2``/``waverec2`` in ``periodization`` against ``ptwt_tpu``
    (float64), and the adjoint identity of both launches' VJPs."""
    rng = np.random.RandomState(8)
    x = rng.randn(*shape)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode="periodization", level=level)
    xt = torch.from_numpy(x).requires_grad_()
    got = tptwt.wavedec2(xt, wavelet, mode="periodization", level=level)
    for g, w_ in zip(_flat(got), _flat(want)):
        _close(g, w_, 1e-10)
    rec = tptwt.waverec2(got, wavelet, mode="periodization")
    _close(rec, jptwt.waverec2(want, wavelet, mode="periodization"), 1e-10)
    assert replay["K5a"] and replay["K5b"] and not replay["K1"]
    # <K x, y> = <x, K^T y> for the analysis and for the synthesis
    outs = _flat(got)
    cts = [torch.from_numpy(rng.randn(*o.shape)) for o in outs]
    (gx,) = torch.autograd.grad(outs, xt, cts, retain_graph=True)
    lhs = sum(float((o.detach() * c).sum()) for o, c in zip(outs, cts))
    norm = np.sqrt(sum(float((o.detach() ** 2).sum()) for o in outs)) * np.sqrt(sum(float((c**2).sum()) for c in cts))
    assert abs(lhs - float((xt.detach() * gx).sum())) <= 1e-12 * norm
    leaves = [o.detach().requires_grad_() for o in outs]
    y = tptwt.waverec2(_nest(leaves, level), wavelet, mode="periodization")
    ct = torch.from_numpy(rng.randn(*y.shape))
    grads = torch.autograd.grad(y, leaves, ct)
    lhs = float((y.detach() * ct).sum())
    norm = float(y.detach().norm() * ct.norm())
    assert abs(lhs - sum(float((l_.detach() * g).sum()) for l_, g in zip(leaves, grads))) <= 1e-12 * norm


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _previous_runs(h, w, filt_len, level, itemsize):
    """The previous plan's ``_pyramid2d_runs`` (64 KB target, cone reads
    within 2.0 of a tile of at most 128 level-0 positions, 512 threads),
    kept as the gate the new plan must cover."""
    limit, target = 232448, 64 * 1024

    def cone(t, depth, lvl):
        return (t << (depth - lvl)) + (filt_len - 2) * ((1 << (depth - lvl)) - 1)

    def tile(h, w, depth, lim):
        t = 128 >> depth
        while t >= 1:
            th, tw = min(t, h >> depth), min(t, w >> depth)
            ch0, cw0, cw1 = cone(th, depth, 0), cone(tw, depth, 0), cone(tw, depth, 1)
            if (ch0 * cw0 + 2 * ch0 * cw1) * itemsize <= lim and ch0 * cw0 <= 2.0 * (th << depth) * (tw << depth):
                return True
            t >>= 1
        return False

    runs = []
    while level > 0:
        if 2 * h * w * itemsize <= limit:
            depth = min(level, 8)
        else:
            depth = next((d for lim in (target, limit) for d in range(min(level, 4), 0, -1) if tile(h, w, d, lim)), None)
            if depth is None:
                return None
        runs.append(depth)
        h, w, level = h >> depth, w >> depth, level - depth
    return tuple(runs)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_accepts_every_shape_the_previous_plan_did(itemsize):
    """The gate takes at least every shape, even filter length and dtype it
    took before the redesign (odd-length banks it declines: their bands
    are not half the axis); the launches run the gate's plan; every
    planned launch fits its reservation."""
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    sizes = [2, 4, 8, 12, 16, 20, 24, 40, 48, 64, 96, 120, 128, 160, 176, 256, 512, 1024]
    checked = 0
    for filt_len in (2, 3, 4, 6, 8, 10, 16, 20, 30, 40, 56, 60, 80, 102, 128):
        for h in sizes:
            for w in sizes:
                for level in (1, 2, 3, 4, 5):
                    if h % (1 << level) or w % (1 << level):
                        continue
                    if filt_len % 2:
                        assert not t5.fused_wavedec2d_applicable(h, w, filt_len, level, dtype)
                        continue
                    before = _previous_runs(h, w, filt_len, level, itemsize)
                    runs = t5._pyramid2d_runs(h, w, filt_len, level, itemsize)
                    assert before is None or runs is not None, (h, w, filt_len, level, itemsize)
                    if runs is None:
                        continue
                    assert t5._plan_runs(h, w, filt_len, level, dtype) == runs
                    checked += 1
                    hh, ww = h, w
                    for depth in runs:
                        for plan in (t5._analysis_plan, t5._synthesis_plan):
                            ints, smem = plan(hh, ww, filt_len, depth, itemsize)
                            assert smem <= t5._SMEM_LIMIT and ints[7] in (0, 1)
                            assert ints[7] or depth <= t5.MAX_TILED_DEPTH
                        hh, ww = hh >> depth, ww >> depth
    assert checked > 1000
