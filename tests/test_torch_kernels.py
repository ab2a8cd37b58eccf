"""K1-K4 of ptwt_tpu_torch against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain torch version; here those
are held against the JAX package's kernels run in Pallas interpret mode
(``_pallas2d.fused2_*_level`` and ``_pallas2.pallas_*_axis``, called as
``tests/test_pallas2d.py`` and ``tests/test_pallas2.py`` call them).

The CUDA glue around the kernels (the arguments each launch gets) is
checked on the CPU too, by running it against a numpy model of the
kernels' index arithmetic; the model also runs the 1d pyramid kernels of
``csrc/fwt1d.cu`` (``tests/test_torch_kernels1d.py``) and the 2d pyramid
kernels of ``csrc/pyramid2d.cu`` (``tests/test_torch_pyramid2d.py``)
block by block, and checks the argument rules of the K9 launches
(``csrc/mxu2d.cu``, ``tests/test_torch_mxu2d.py``), which compute what
K1/K2 launched with the same arguments compute.  Its K3/K4 entries and their VJPs apply sparse operators
(one entry per tap), so long lanes can be modelled too.
The kernels themselves are held against their plain versions on the card
in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu.ops import _pallas2 as j2
from ptwt_tpu.ops import _pallas2d as j2d
from ptwt_tpu.ops._dispatch import analysis_nd as j_analysis_nd
from ptwt_tpu.ops._dispatch import synthesis_nd as j_synthesis_nd
from ptwt_tpu.utils import get_filter_arrays as j_filters
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _mxu2d as t9
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d
from ptwt_tpu_torch.utils._padding import source_index
from _torch_one_thread import one_torch_thread  # noqa: F401

AXIS_MODES = ["zero", "reflect", "periodic", "symmetric", "constant", "periodization", "valid"]


def _std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


def _banks(wavelet, dtype=np.float32):
    dl, dh, _, _ = j_filters(wavelet, flip=True, dtype=dtype)
    _, _, rl, rh = j_filters(wavelet, flip=False, dtype=dtype)
    return [np.asarray(f) for f in (dl, dh, rl, rh)]


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# K1 / K2: plain versions against the JAX level kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["periodization", "periodic"])
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4", "sym5"])
@pytest.mark.parametrize("shape", [(3, 16, 256), (2, 64, 256), (2, 20, 36)])
def test_fused2_level_matches_jax(shape, wavelet, mode):
    dl, dh, rl, rh = _banks(wavelet)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    p = 0 if mode == "periodization" else _std_pad(len(dl))
    if shape[-1] & (shape[-1] - 1):
        # the Pallas kernels unshuffle power-of-two axes only; the JAX
        # package's per-axis route is the reference for other shapes
        want = j_analysis_nd(jnp.asarray(x), dl, dh, mode=mode, ndim=2)
        want_rec = j_synthesis_nd(
            want, jnp.asarray(rl), jnp.asarray(rh), pads=[(p, p)] * 2, mode=mode, ndim=2
        )
    else:
        want = j2d.fused2_dwt_level(jnp.asarray(x), dl, dh, mode)
        want_rec = j2d.fused2_idwt_level(want, rl, rh, mode)
    assert t2d.fused2_analysis_applicable(shape[1], shape[2], len(dl), mode)
    got = t2d.fused2_dwt_level(torch.from_numpy(x), dl, dh, mode)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    bands = [torch.from_numpy(np.array(w)) for w in want]
    assert t2d.fused2_synthesis_applicable(*bands[0].shape[-2:], len(rl), mode, [(p, p)] * 2)
    rec = t2d.fused2_idwt_level(bands, rl, rh, mode)
    _close(rec, want_rec, 2e-5)
    _close(rec, x, 2e-5)


def test_fused2_periodic_arbitrary_coefficients():
    """K2's periodic crop is exact for coefficients that are not a wavedec
    output (thresholded)."""
    dl, dh, rl, rh = _banks("db3")
    x = jnp.asarray(np.random.RandomState(8).randn(2, 32, 256), dtype=jnp.float32)
    bands = j_analysis_nd(x, dl, dh, mode="periodic", ndim=2)
    thr = tuple(jnp.where(jnp.abs(b) > 0.7, b, 0.0) for b in bands)
    want = j2d.fused2_idwt_level(thr, rl, rh, "periodic")
    got = t2d.fused2_idwt_level([torch.from_numpy(np.array(b)) for b in thr], rl, rh, "periodic")
    _close(got, want, 2e-5)


def test_fused2_gates():
    # periodic needs an even shape; padded modes never take K1/K2
    assert t2d.fused2_analysis_applicable(20, 36, 8, "periodic")
    assert not t2d.fused2_analysis_applicable(21, 36, 8, "periodic")
    assert t2d.fused2_analysis_applicable(21, 35, 8, "periodization")
    assert not t2d.fused2_analysis_applicable(64, 64, 8, "reflect")
    # the half-size axes must cover the tap reach ((2L-3)//2 // 2 + 2)
    assert not t2d.fused2_analysis_applicable(10, 64, 8, "periodization")
    assert t2d.fused2_analysis_applicable(12, 64, 8, "periodization")
    # synthesis: standard crops only
    assert t2d.fused2_synthesis_applicable(515, 515, 8, "periodic", [(6, 6), (6, 6)])
    assert not t2d.fused2_synthesis_applicable(261, 261, 8, "periodic", [(6, 7), (6, 7)])
    assert not t2d.fused2_synthesis_applicable(32, 32, 8, "periodization", [(0, 1), (0, 0)])
    assert not t2d.fused2_synthesis_applicable(32, 32, 8, "reflect", [(6, 6), (6, 6)])


# ---------------------------------------------------------------------------
# K3 / K4: plain versions against the JAX axis kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", AXIS_MODES)
@pytest.mark.parametrize(
    "shape,axis",
    [((3, 70), -1), ((3, 70, 5), -2), ((2, 4, 33), -1), ((7, 65), -1), ((2, 516), -1)],
)
@pytest.mark.parametrize("wavelet", ["haar", "db3"])
def test_axis_kernels_match_jax(mode, shape, axis, wavelet):
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jlo, jhi = j2.pallas_dwt_axis(jnp.asarray(x), axis, dl, dh, mode)
    got = t2.pallas_dwt_axis(torch.from_numpy(x), axis, dl, dh, mode)
    _close(got[0], jlo, 2e-5)
    _close(got[1], jhi, 2e-5)
    pad = 0 if mode in ("periodization", "valid") else len(dl) - 2
    want = j2.pallas_idwt_axis(jlo, jhi, axis, rl, rh, pad, pad, mode)
    lo = torch.from_numpy(np.array(jlo))
    hi = torch.from_numpy(np.array(jhi))
    rec = t2.pallas_idwt_axis([lo], [hi], axis, rl, rh, pad, pad, mode)
    _close(rec[0], want, 2e-5)


# ---------------------------------------------------------------------------
# the CUDA glue, against a numpy model of the kernels' index arithmetic
# ---------------------------------------------------------------------------


def _analysis_op(taps, m, n, period, pad, circular):
    """``[m, n]`` operator of one K1/K3 axis: ``x[wrap(2i - pad + k)]``,
    or zero outside ``[0, n)`` when not circular."""
    op = np.zeros((m, n))
    for i in range(m):
        for k, c in enumerate(taps):
            r = 2 * i - pad + k
            if circular:
                r = min(r % period, n - 1)
            elif not 0 <= r < n:
                continue
            op[i, r] += c
    return op


def _synthesis_op(taps, out_len, m, off, circular, half=None, per=None):
    """``[out_len, m]`` operator of one K2/K4 axis: ``band[(t + off - k) / 2]``.

    Circular reads go modulo ``half`` (default ``m``) and also collect the
    band rows ``+ half, + 2 half, ... < m``; positions ``t`` in
    ``[out_len, per)`` land on the last output (the K2 fold).
    """
    half = half or m
    op = np.zeros((out_len, m))
    for t in range(per or out_len):
        f = t + off
        for k in range(f & 1, len(taps), 2):
            q = (f - k) >> 1
            if circular:
                rows = range(q % half, m, half)
            elif 0 <= q < m:
                rows = [q]
            else:
                continue
            for row in rows:
                op[min(t, out_len - 1), row] += taps[k]
    return op


#: How the K3/K4 entries read a position outside the axis: the AXIS_*
#: codes of ``csrc/axis.cu`` 0-3 are these pywt modes; 4 reads modulo the
#: period with positions past ``n`` on ``n - 1`` (periodic,
#: periodization), 5 modulo the period with zeros past ``n``.
_AXIS_MODES = ("zero", "constant", "symmetric", "reflect")


def _axis_source(p, n, period, code):
    """Source index of each extended position under mode ``code``, -1 for a zero."""
    if code < len(_AXIS_MODES):
        return source_index(p, n, _AXIS_MODES[code])
    q = np.mod(p, period)
    return np.where(q < n, q, n - 1 if code == 4 else -1)


def _analysis_sparse(taps, m, n, period, pad, code):
    """K3 as a sparse ``[m, n]`` matrix, one entry per tap: band ``i``
    reads ``x[src(2i - pad + k)]``."""
    taps = np.asarray(taps, dtype=np.float64)
    i = np.repeat(np.arange(m), len(taps))
    k = np.tile(np.arange(len(taps)), m)
    r = _axis_source(2 * i - pad + k, n, period, code)
    keep = r >= 0
    return scipy.sparse.csr_matrix((taps[k][keep], (i[keep], r[keep])), shape=(m, n))


def _synthesis_sparse(taps, out_len, m, off, circular):
    """:func:`_synthesis_op` (no fold) as a sparse ``[out_len, m]`` matrix."""
    taps = np.asarray(taps, dtype=np.float64)
    t = np.repeat(np.arange(out_len), len(taps))
    k = np.tile(np.arange(len(taps)), out_len)
    f = t + off - k
    q = f // 2
    keep = f % 2 == 0
    if circular:
        q = q % m
    else:
        keep &= (q >= 0) & (q < m)
    return scipy.sparse.csr_matrix((taps[k][keep], (t[keep], q[keep])), shape=(out_len, m))


def _apply(op, arr):
    """``op`` along the middle axis of ``[outer, a, inner]``."""
    outer, a, inner = arr.shape
    flat = arr.transpose(1, 0, 2).reshape(a, outer * inner)
    return np.asarray(op @ flat).reshape(op.shape[0], outer, inner).transpose(1, 0, 2)


_BAND_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))  # (H, W) taps of ll, lh, hl, hh


_PADDED = ("zero", "reflect", "periodic", "symmetric", "constant")


def _split_half(count):
    """``split_half`` of ``csrc/fwt1d.cu``: one parity half of a staged cone."""
    return ((count + 1) // 2 + 16 + 3) & ~3


def _model_analysis_1d(x, lo_out, his, lo, hi, n_taps, rows, plan, circular, smem, itemsize):
    """``ptwt_fwt1d_analysis`` block by block: each tile's cone (per-level
    offsets, zero or modulo reads, cone values outside their band zeroed),
    the four-output windows' reads within the split halves, the positions
    it owns, and the edge block's strips, with the kernel's index
    arithmetic.  Every band position must be written exactly once."""
    p = list(plan)
    assert len(p) == 28
    depth, n, padl, tile, tiles, mode, strip, edge = p[:8]
    m, wl, wr, pads = p[8:13], p[13:18], p[18:23], p[23:28]
    assert m[0] == n and not (circular and edge)
    f = np.array([lo[:n_taps], hi[:n_taps]])  # [2, L]
    xs = x.numpy().reshape(rows, n).astype(np.float64)
    bands = [np.full((rows, m[depth]), np.nan)] + [np.full((rows, m[lvl]), np.nan) for lvl in range(1, depth + 1)]
    chunks = ((n_taps + 1) // 2 + 6) // 4

    def put(band, pos, vals):
        assert np.isnan(band[:, pos]).all(), "a band position was written twice"
        band[:, pos] = vals

    for lvl in range(1, depth + 1):
        assert tiles * (tile << (depth - lvl)) >= m[lvl], "the tiles do not cover a level"
    c = [0] * (depth + 1)
    c[depth] = tile
    for lvl in range(depth, 0, -1):
        c[lvl - 1] = 2 * c[lvl] + n_taps - 2
    halves = [_split_half(c[0]), _split_half(c[1]) if depth > 1 else 0]
    # the output buffer: every level's hi, and lo at level D after round4(T)
    outs = (max(c[1], 2 * ((tile + 3) & ~3)) + 3) & ~3
    assert all((c[lvl] + 3) & ~3 <= outs for lvl in range(1, depth + 1))
    need = 2 * sum(halves) + outs
    for lvl in range(1, depth + 1):
        # the last window of level lvl reads its split cone up to here
        assert 4 * ((c[lvl] + 3) // 4 - 1) + 4 * chunks <= halves[(lvl - 1) & 1]
    for t in range(tiles):
        s = [0] * (depth + 1)
        s[depth] = t * tile
        for lvl in range(depth, 0, -1):
            s[lvl - 1] = 2 * s[lvl] - pads[lvl]
        pos = s[0] + np.arange(c[0])
        if circular:
            cur = xs[:, pos % n]
        else:
            cur = np.where((pos >= 0) & (pos < n), xs[:, np.clip(pos, 0, n - 1)], 0.0)
        for lvl in range(1, depth + 1):
            win = cur[:, 2 * np.arange(c[lvl])[:, None] + np.arange(n_taps)[None, :]]
            lo_v, hi_v = win @ f[0], win @ f[1]
            i = s[lvl] + np.arange(c[lvl])
            own = tile << (depth - lvl)
            first, last = max(t * own, wl[lvl]), min(t * own + own, m[lvl] - wr[lvl])
            sel = (i >= first) & (i < last)
            put(bands[lvl], i[sel], hi_v[:, sel])
            if lvl == depth:
                put(bands[0], i[sel], lo_v[:, sel])
            cur = lo_v if circular else np.where((i >= 0) & (i < m[lvl]), lo_v, 0.0)
    if edge:
        e_prev = strip << depth
        need = max(need, 3 * e_prev)
        cur = np.concatenate([xs[:, :e_prev], xs[:, n - e_prev :]], axis=1)
        for lvl in range(1, depth + 1):
            mp, ml, e = m[lvl - 1], m[lvl], e_prev >> 1
            i = np.concatenate([np.arange(e), ml - e + np.arange(e)])
            src = source_index(2 * i[:, None] + np.arange(n_taps)[None, :] - padl, mp, _PADDED[mode])
            inside = (src < e_prev) | (src >= mp - e_prev)
            assert inside.all(), "an edge read fell outside both strips"
            at = np.where(src < e_prev, src, e_prev + src - (mp - e_prev))
            vals = np.where(src >= 0, cur[:, np.clip(at, 0, 2 * e_prev - 1)], 0.0)
            lo_v, hi_v = vals @ f[0], vals @ f[1]
            write = np.concatenate([np.arange(e) < wl[lvl], ml - e + np.arange(e) >= ml - wr[lvl]])
            put(bands[lvl], i[write], hi_v[:, write])
            if lvl == depth:
                put(bands[0], i[write], lo_v[:, write])
            cur, e_prev = lo_v, e
    assert need * itemsize <= smem, "the launch's shared memory is too small"
    for band in bands:
        assert not np.isnan(band).any(), "a band position was never written"
    for t, band in zip([lo_out, *his[:depth]], bands):
        t.copy_(torch.from_numpy(band).reshape(t.shape))


def _model_synthesis_edges(bands_in, f, n_taps, plan, result):
    """The edge block of K8a's VJP for every row: the chain on [head |
    tail] strips, pywt's extension folded back at every step, the first
    and last ``wz`` outputs written.  Every read and every fold target
    must land in a strip."""
    depth = plan[0]
    lens, offs = plan[4:9], plan[9:14]
    mode, _, wz, ebuf = plan[14:18]
    strips = plan[18:23]
    pad = offs[1]
    assert 0 <= wz <= strips[0] and all(o == pad for o in offs[1 : depth + 1])

    def take(band, e, size):
        assert 1 <= e <= size and 2 * e <= ebuf
        return band[:, np.concatenate([np.arange(e), size - e + np.arange(e)])]

    def gather(lo_s, hi_s, fs, e, size):
        acc = np.zeros((lo_s.shape[0], fs.size))
        for k in range(n_taps):
            q = (fs - k) // 2
            use = ((fs - k) % 2 == 0) & (q >= 0) & (q < size)
            assert ((q < e) | (q >= size - e))[use].all(), "a read fell outside both strips"
            at = np.clip(np.where(q < e, q, e + q - (size - e)), 0, 2 * e - 1)
            acc += np.where(use, f[0, k] * lo_s[:, at] + f[1, k] * hi_s[:, at], 0.0)
        return acc

    cur = take(bands_in[depth][0], strips[depth], lens[depth])
    for lvl in range(depth, 0, -1):
        m, mp, e, eo = lens[lvl], lens[lvl - 1], strips[lvl], strips[lvl - 1]
        hib = take(bands_in[lvl][1], e, m)
        ps = np.concatenate([np.arange(-pad, 0), mp + np.arange(pad + mp % 2)])
        ext = gather(cur, hib, ps + pad, e, m)
        tgt = source_index(ps, mp, _PADDED[mode])
        t = np.concatenate([np.arange(eo), mp - eo + np.arange(eo)])
        reached = tgt[tgt >= 0]
        assert ((reached < eo) | (reached >= mp - eo)).all(), "a fold target fell outside both strips"
        acc = gather(cur, hib, t + pad, e, m) + ext @ (tgt[:, None] == t[None, :]).astype(float)
        if lvl > 1:
            cur = acc
            continue
        write = np.concatenate([np.arange(eo) < wz, (t[eo:] >= mp - wz) & (t[eo:] >= wz)])
        assert np.isnan(result[:, t[write]]).all(), "an output was written twice"
        result[:, t[write]] = acc[:, write]


def _model_synthesis_1d(lo_in, his, out, rlo, rhi, n_taps, rows, plan, circular, smem, itemsize):
    """``ptwt_fwt1d_synthesis`` tile by tile, with the kernel's cone ranges
    (checked against the plan's buffers), zero / modulo band reads, the
    output pairs' band rows within the staged range, and for K8a's VJP the
    edge block (:func:`_model_synthesis_edges`)."""
    p = list(plan)
    assert len(p) == 23
    depth, tile, tiles, buf = p[:4]
    lens, offs = p[4:9], p[9:14]
    edge, wz, ebuf = p[15:18]
    assert not (circular and edge)
    spans = [tile]
    for _ in range(depth):
        spans.append((spans[-1] + n_taps - 1) // 2 + 1)
    # every hi band and lo_D at once, and two intermediate lo buffers
    assert buf >= sum(spans[1:]) + spans[depth] + sum(spans[1 : min(depth, 3)])
    need = buf * itemsize
    if edge:
        need = max(need, (3 * ebuf + 2 * offs[1] + 2) * itemsize + 4 * (2 * offs[1] + 2))
    assert need <= smem, "the launch's shared memory is too small"
    f = np.array([rlo[:n_taps], rhi[:n_taps]])
    lo_d = lo_in.numpy().reshape(rows, lens[depth]).astype(np.float64)
    hi_bands = {lvl: his[lvl - 1].numpy().reshape(rows, lens[lvl]).astype(np.float64)
                for lvl in range(1, depth + 1)}
    result = np.full((rows, lens[0]), np.nan)
    nh = (n_taps + 1) // 2

    def load(band, start, count, size):
        q = start + np.arange(count)
        if circular:
            return band[:, q % size]
        return np.where((q >= 0) & (q < size), band[:, np.clip(q, 0, size - 1)], 0.0)

    for t in range(tiles):
        c, e = [t * tile] + [0] * depth, [t * tile + tile - 1] + [0] * depth
        for lvl in range(1, depth + 1):
            c[lvl] = (c[lvl - 1] + offs[lvl] - (n_taps - 1)) // 2
            e[lvl] = (e[lvl - 1] + offs[lvl]) // 2
            assert e[lvl] - c[lvl] + 1 <= spans[lvl], "a band range outgrew its buffer"
            # the pairs' band rows u - j, j < ceil(L/2), lie in the staged range
            u0, u1 = (c[lvl - 1] + offs[lvl]) // 2, (e[lvl - 1] + offs[lvl]) // 2
            assert u0 - nh + 1 >= c[lvl] and u1 <= e[lvl]
        cur = load(lo_d, c[depth], e[depth] - c[depth] + 1, lens[depth])
        for lvl in range(depth, 0, -1):
            hb = load(hi_bands[lvl], c[lvl], e[lvl] - c[lvl] + 1, lens[lvl])
            pos = c[lvl - 1] + np.arange(e[lvl - 1] - c[lvl - 1] + 1)
            fo = pos + offs[lvl]
            acc = np.zeros((rows, pos.size))
            for k in range(n_taps):
                even = (fo - k) % 2 == 0
                q = (fo - k) // 2 - c[lvl]
                qc = np.clip(q, 0, cur.shape[1] - 1)
                acc += np.where(even, f[0, k] * cur[:, qc] + f[1, k] * hb[:, qc], 0.0)
            if lvl > 1:
                if not circular:
                    acc[:, (pos < 0) | (pos >= lens[lvl - 1])] = 0.0
                cur = acc
            else:
                sel = (pos >= wz) & (pos < lens[0] - wz)
                assert np.isnan(result[:, pos[sel]]).all(), "an output was written twice"
                result[:, pos[sel]] = acc[:, sel]
    if edge:
        bands_in = {depth: (lo_d, hi_bands[depth])}
        bands_in.update({lvl: (None, hi_bands[lvl]) for lvl in range(1, depth)})
        _model_synthesis_edges(bands_in, f, n_taps, p, result)
    assert not np.isnan(result).any(), "an output was never written"
    out.copy_(torch.from_numpy(result).reshape(out.shape))


def _model_pyramid2d_analysis(x, ll_out, det, lo, hi, n_taps, batch, plan, smem, itemsize):
    """``ptwt_pyramid2d_analysis`` block by block: each tile's cone per
    axis (modulo the image, or the whole image read modulo in shared
    memory), the row and column passes, and the positions each block owns.
    Every band position must be written exactly once."""
    depth, h, w, th, tw, tiles_h, tiles_w, whole, pad, buf_a, buf_b, bufs = list(plan)
    need = t6._analysis_need(depth, h, w, th, tw, whole, n_taps, itemsize)
    assert buf_a >= need[0] and buf_b >= need[1], "the launch's buffers are too small"
    assert bufs in (1, 2) and (bufs * buf_a + buf_b) * itemsize <= smem <= t6._SMEM_LIMIT, "the launch's shared memory is too small"
    assert whole or (depth <= t6.MAX_TILED_DEPTH and bufs == 1)
    le = n_taps + (n_taps & 1)  # an odd bank's cone reads one zero tap more
    f = np.array([lo[:n_taps], hi[:n_taps]])
    taps = np.arange(n_taps)
    xs = x.numpy().reshape(batch, h, w).astype(np.float64)
    bands = [[np.full((batch, h >> lvl, w >> lvl), np.nan) for _ in range(3)] for lvl in range(depth + 1)]
    ll_d = np.full((batch, h >> depth, w >> depth), np.nan)

    def put(band, rows, cols, vals):
        assert np.isnan(band[:, rows[:, None], cols[None, :]]).all(), "a band position was written twice"
        band[:, rows[:, None], cols[None, :]] = vals

    def cone(first, t, size):
        s, c = [0] * (depth + 1), [0] * (depth + 1)
        s[depth], c[depth] = first, t
        for lvl in range(depth, 0, -1):
            if whole:
                s[lvl - 1], c[lvl - 1] = 0, size >> (lvl - 1)
            else:
                s[lvl - 1], c[lvl - 1] = 2 * s[lvl] - pad, 2 * c[lvl] + le - 2
        return s, c

    def reads(c_out, size):  # [c_out, L] cone offsets of one pass
        idx = 2 * np.arange(c_out)[:, None] + taps[None, :]
        return (idx - pad) % size if whole else idx

    for ty in range(tiles_h):
        for tx in range(tiles_w):
            sh, ch = cone(ty * th, th, h)
            sw, cw = cone(tx * tw, tw, w)
            # the buffers hold this cone: A the staged input, then each
            # level's four bands; B the H pass's two outputs of each level
            assert ch[0] * cw[0] <= buf_a, "the staged cone overflows buffer A"
            for lvl in range(1, depth + 1):
                assert 4 * ch[lvl] * cw[lvl] <= buf_a, "a level's bands overflow buffer A"
                assert 2 * ch[lvl] * cw[lvl - 1] <= buf_b, "a level's H pass overflows buffer B"
            rows, cols = (sh[0] + np.arange(ch[0])) % h, (sw[0] + np.arange(cw[0])) % w
            cur = xs[:, rows[:, None], cols[None, :]]
            for lvl in range(1, depth + 1):
                win = cur[:, :, reads(cw[lvl], w >> (lvl - 1))]  # [b, ch, cw_l, L]
                lo_w, hi_w = win @ f[0], win @ f[1]
                ridx = reads(ch[lvl], h >> (lvl - 1))
                a_, b_ = lo_w[:, ridx, :], hi_w[:, ridx, :]  # [b, ch_l, L, cw_l]
                ll = np.einsum("bilj,l->bij", a_, f[0])
                subs = [np.einsum("bilj,l->bij", a_, f[1]), np.einsum("bilj,l->bij", b_, f[0]),
                        np.einsum("bilj,l->bij", b_, f[1])]
                gi, gj = sh[lvl] + np.arange(ch[lvl]), sw[lvl] + np.arange(cw[lvl])
                own_h, own_w = th << (depth - lvl), tw << (depth - lvl)
                sel_h = (gi >= ty * own_h) & (gi < min(ty * own_h + own_h, h >> lvl))
                sel_w = (gj >= tx * own_w) & (gj < min(tx * own_w + own_w, w >> lvl))
                for band, vals in zip(bands[lvl], subs):
                    put(band, gi[sel_h], gj[sel_w], vals[:, sel_h][:, :, sel_w])
                if lvl == depth:
                    put(ll_d, gi[sel_h], gj[sel_w], ll[:, sel_h][:, :, sel_w])
                cur = ll
    outs = [ll_d] + [band for lvl in range(1, depth + 1) for band in bands[lvl]]
    for t, band in zip([ll_out, *det], outs):
        assert not np.isnan(band).any(), "a band position was never written"
        t.copy_(torch.from_numpy(band).reshape(t.shape))
    assert all(t is None for t in det[3 * depth :])


def _model_pyramid2d_synthesis(ll_in, det, out, lo, hi, n_taps, batch, plan, smem, itemsize):
    """``ptwt_pyramid2d_synthesis`` tile by tile: each step's read ranges
    (checked against the plan's buffers), band reads modulo their size,
    the H pass then the W pass.  Every output is written exactly once."""
    depth, h, w, th, tw, tiles_h, tiles_w, whole, pad, buf_a, buf_b, bufs = list(plan)
    need = t6._synthesis_need(depth, h, w, th, tw, whole, n_taps, itemsize)
    assert buf_a >= need[0] and buf_b >= need[1], "the launch's buffers are too small"
    assert bufs in (1, 2) and (bufs * buf_a + buf_b) * itemsize <= smem <= t6._SMEM_LIMIT, "the launch's shared memory is too small"
    assert whole or (depth <= t6.MAX_TILED_DEPTH and bufs == 1)
    f = np.array([lo[:n_taps], hi[:n_taps]])
    taps = np.arange(n_taps)
    ll_d = ll_in.numpy().reshape(batch, h >> depth, w >> depth).astype(np.float64)
    dets = [[det[3 * (lvl - 1) + o].numpy().reshape(batch, h >> lvl, w >> lvl) for o in range(3)]
            for lvl in range(1, depth + 1)]
    result = np.full((batch, h, w), np.nan)

    def ranges(first, t, size):
        c, e = [first] + [0] * depth, [first + t - 1] + [0] * depth
        for lvl in range(1, depth + 1):
            if whole:
                c[lvl], e[lvl] = 0, (size >> lvl) - 1
            else:
                c[lvl] = (c[lvl - 1] + pad - (n_taps - 1)) // 2
                e[lvl] = (e[lvl - 1] + pad) // 2
        return c, e

    def step(c_out, n_out, c_in, n_in, size):
        """``[n_out, L]`` band offsets of one synthesis pass and their mask."""
        fk = c_out + np.arange(n_out)[:, None] + pad - taps[None, :]
        even = fk % 2 == 0
        q = (fk // 2) % size if whole else fk // 2 - c_in
        assert ((q[even] >= 0) & (q[even] < n_in)).all()
        return np.clip(q, 0, n_in - 1), even

    for ty in range(tiles_h):
        for tx in range(tiles_w):
            ch, eh = ranges(ty * th, th, h)
            cw, ew = ranges(tx * tw, tw, w)
            nh = [e - c + 1 for c, e in zip(ch, eh)]
            nw = [e - c + 1 for c, e in zip(cw, ew)]
            for lvl in range(1, depth + 1):  # within the buffers' bounds
                assert nh[lvl] <= t6._span_at(th, h, n_taps, whole, lvl)
                assert nw[lvl] <= t6._span_at(tw, w, n_taps, whole, lvl)
            # the buffers hold these ranges: A every staged band, then the
            # outputs; B a step's ll (below the top) beside its H pass's two
            # outputs, and the ll it writes beside them
            staged = nh[depth] * nw[depth] + 3 * sum(nh[lvl] * nw[lvl] for lvl in range(1, depth + 1))
            assert staged <= buf_a and nh[0] * nw[0] <= buf_a, "the staged bands overflow buffer A"
            for lvl in range(1, depth + 1):
                low = 2 * nh[lvl - 1] * nw[lvl]
                assert (nh[lvl] * nw[lvl] if lvl < depth else 0) + low <= buf_b, "a step overflows buffer B"
                assert (nh[lvl - 1] * nw[lvl - 1] if lvl > 1 else 0) + low <= buf_b, "a step overflows buffer B"

            def load(band, lvl):
                rows = (ch[lvl] + np.arange(nh[lvl])) % (h >> lvl)
                cols = (cw[lvl] + np.arange(nw[lvl])) % (w >> lvl)
                return band[:, rows[:, None], cols[None, :]]

            cur = load(ll_d, depth)
            for lvl in range(depth, 0, -1):
                lh, hl, hh = (load(b, lvl) for b in dets[lvl - 1])
                q, even = step(ch[lvl - 1], nh[lvl - 1], ch[lvl], nh[lvl], h >> lvl)
                lo_w = np.zeros((batch, nh[lvl - 1], nw[lvl]))
                hi_w = np.zeros_like(lo_w)
                for k in range(n_taps):
                    m = even[:, k][None, :, None]
                    lo_w += np.where(m, f[0, k] * cur[:, q[:, k]] + f[1, k] * lh[:, q[:, k]], 0.0)
                    hi_w += np.where(m, f[0, k] * hl[:, q[:, k]] + f[1, k] * hh[:, q[:, k]], 0.0)
                q, even = step(cw[lvl - 1], nw[lvl - 1], cw[lvl], nw[lvl], w >> lvl)
                acc = np.zeros((batch, nh[lvl - 1], nw[lvl - 1]))
                for k in range(n_taps):
                    m = even[:, k][None, None, :]
                    acc += np.where(m, f[0, k] * lo_w[:, :, q[:, k]] + f[1, k] * hi_w[:, :, q[:, k]], 0.0)
                cur = acc
            rows, cols = ch[0] + np.arange(nh[0]), cw[0] + np.arange(nw[0])
            sel_h, sel_w = rows < h, cols < w
            block = result[:, rows[sel_h][:, None], cols[sel_w][None, :]]
            assert np.isnan(block).all(), "an output was written twice"
            result[:, rows[sel_h][:, None], cols[sel_w][None, :]] = cur[:, sel_h][:, :, sel_w]
    assert not np.isnan(result).any(), "an output was never written"
    out.copy_(torch.from_numpy(result).reshape(out.shape))


def _model_mxu2d(entry, dtype, a):
    """The argument rules of ``ptwt_mxu2d_*`` (``csrc/mxu2d.cu``): float32,
    at most 64 taps, for the synthesis no clamped output rows, and the
    tile plan of ``ops/_mxu2d.py`` last (``tests/test_torch_mxu2d_tiles.py``
    replays the kernels on it); the launch then computes what the K1/K2
    launch with the same arguments does.  Returns that entry's name and
    arguments."""
    assert dtype == torch.float32, "K9 takes float32 only"
    *a, plan, plan_len = a
    assert len(plan) == plan_len
    if entry == "ptwt_mxu2d_analysis":
        n_taps, circ = a[4], a[13]
        assert not circ or (a[8] >= a[6] and a[9] >= a[7])
        assert 1 <= n_taps <= 64
        assert list(plan) == list(t9.analysis_plan(n_taps, a[12], a[10], a[11]))
        return "ptwt_dwt2", a
    n_taps, m_h, m_w, out_h, out_w, circ, half_h, half_w, per_h, per_w = a[7], *a[9:13], *a[15:20]
    assert 1 <= n_taps <= 64
    assert (per_h, per_w) == (out_h, out_w), "K9b writes no clamped output rows"
    assert circ or (half_h, half_w) == (m_h, m_w), "a fold needs circular reads"
    assert list(plan) == list(t9.synthesis_plan(n_taps, a[13], a[14], m_h, m_w, out_h, out_w))
    return "ptwt_idwt2", a


def _model_tap_grad(x, lo0, hi0, lo1, hi1, groups, out, partial, cap, n_taps, outer, n, period, m, inner,
                    pad, code):
    """KT (``ptwt_tap_grad``): ``g_f[k] = sum band_f[j] x[src(2j + k - pad)]``
    over every row and column, pair ``g``'s bands under ``x``'s group ``g``,
    with the C entry's argument rules."""
    assert 1 <= groups <= 2 and 1 <= n_taps <= 128 and cap >= 1 and min(outer, inner, n, m) >= 1
    assert pad >= 0 and 0 <= code <= 5 and (code < 4 or period >= n)
    assert partial.shape == (cap, 2 * n_taps) and out.shape == (2, n_taps)
    assert out.dtype == partial.dtype == torch.float64
    pos = 2 * np.arange(m)[:, None] - pad + np.arange(n_taps)[None, :]
    src = _axis_source(pos, n, period, code)  # [m, n_taps]
    xs = x.numpy().reshape(groups, outer, n, inner).astype(np.float64)
    res = np.zeros((2, n_taps))
    for g, pair in enumerate([(lo0, hi0), (lo1, hi1)][:groups]):
        ext = np.where((src >= 0)[None, :, :, None], xs[g][:, np.maximum(src, 0), :], 0.0)
        for f, band in enumerate(pair):
            res[f] += np.einsum("omc,omkc->k", band.numpy().reshape(outer, m, inner), ext)
    out.copy_(torch.from_numpy(res))


def _model_launch(kernel, entry, device, dtype, *a):
    """Stand-in for ``_kernels.launch`` that runs the kernels' index rules;
    a VJP launch runs the transpose of its forward's operator (K3's VJP,
    K4's fold instance, as the transposed K3 operator)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if entry == "ptwt_tap_grad":
        _model_tap_grad(*a)
        _kernels.LAUNCHES[kernel] += 1
        return
    if entry.startswith("ptwt_mxu2d_"):
        entry, a = _model_mxu2d(entry, dtype, a)
    if entry == "ptwt_fwt1d_analysis":
        x, lo_out, *his = a[:6]
        _model_analysis_1d(x, lo_out, his, *a[6:], itemsize)
        _kernels.LAUNCHES[kernel] += 1
        return
    if entry == "ptwt_fwt1d_synthesis":
        lo_in, *his = a[:5]
        _model_synthesis_1d(lo_in, his, *a[5:], itemsize)
        _kernels.LAUNCHES[kernel] += 1
        return
    if entry in ("ptwt_pyramid2d_analysis", "ptwt_pyramid2d_synthesis"):
        model = _model_pyramid2d_analysis if entry.endswith("analysis") else _model_pyramid2d_synthesis
        model(*a, itemsize)
        _kernels.LAUNCHES[kernel] += 1
        return
    if entry == "ptwt_analysis_axis":
        x, out, lo, hi, n_taps, outer, n, period, m, inner, pad, code = a
        assert 0 <= code <= 5 and pad >= 0 and (code < 4 or period >= n)
        xs = x.numpy().reshape(outer, n, inner)
        res = [_apply(_analysis_sparse(t[:n_taps], m, n, period, pad, code), xs) for t in (lo, hi)]
    elif entry == "ptwt_synthesis_axis":
        (lo0, hi0, lo1, hi1, groups, out, rl, rh, n_taps, outer, m, out_len, inner, off,
         circ, fold, period) = a
        assert off >= 0 and 0 <= fold <= 5
        if fold:
            # K3's VJP: the transpose of the K3 launch it differentiates
            assert groups == 1 and not circ and (fold < 4 or period >= out_len)
            s_lo, s_hi = (_analysis_sparse(t[:n_taps], m, out_len, period, off, fold).T for t in (rl, rh))
        else:
            s_lo = _synthesis_sparse(rl[:n_taps], out_len, m, off, circ)
            s_hi = _synthesis_sparse(rh[:n_taps], out_len, m, off, circ)
        res = [
            _apply(s_lo, lo.numpy().reshape(outer, m, inner))
            + _apply(s_hi, hi.numpy().reshape(outer, m, inner))
            for lo, hi in [(lo0, hi0), (lo1, hi1)][:groups]
        ]
    elif entry == "ptwt_dwt2":
        x, out, lo, hi, n_taps, b, h, w, per_h, per_w, m_h, m_w, pad, circ = a
        ops = {
            ax: [_analysis_op(t[:n_taps], m_, n_, per_, pad, circ) for t in (lo, hi)]
            for ax, m_, n_, per_ in (("h", m_h, h, per_h), ("w", m_w, w, per_w))
        }
        xs = x.numpy()
        res = [
            np.einsum("im,bmn,jn->bij", ops["h"][bh], xs, ops["w"][bw], optimize=True)
            for bh, bw in _BAND_TAPS
        ]
    else:  # ptwt_idwt2
        (ll, lh, hl, hh, out, lo, hi, n_taps, b, m_h, m_w, out_h, out_w, off_h, off_w,
         circ, half_h, half_w, per_h, per_w) = a
        sh = [_synthesis_op(t[:n_taps], out_h, m_h, off_h, circ, half_h, per_h) for t in (lo, hi)]
        sw = [_synthesis_op(t[:n_taps], out_w, m_w, off_w, circ, half_w, per_w) for t in (lo, hi)]
        res = sum(
            np.einsum("um,bmn,vn->buv", sh[bh], band.numpy(), sw[bw], optimize=True)
            for band, (bh, bw) in zip((ll, lh, hl, hh), _BAND_TAPS)
        )
    out.copy_(torch.from_numpy(np.asarray(res)).reshape(out.shape))
    _kernels.LAUNCHES[kernel] += 1


@pytest.fixture
def model_kernels(monkeypatch):
    """Send CPU tensors down the CUDA glue, launching the numpy model."""
    monkeypatch.setattr(_kernels, "launch", _model_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    for module in (t2, t2d, t6, t7, t8):
        monkeypatch.setattr(module, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


@pytest.mark.parametrize(
    "shape,wavelet,mode,used",
    [
        # the headline's pattern: K1 on even levels, K3 on odd ones, K2 on
        # the standard crops, K4 on the odd crops
        ((1, 66, 70), "db3", "periodic", "K1 K2 K3 K4"),
        ((1, 40, 36), "db2", "periodic", "K1 K2 K3 K4"),
        ((2, 31, 33), "db4", "periodization", "K1 K2 K4"),
        ((1, 14, 18), "sym5", "periodization", "K1 K2 K3 K4"),
        ((2, 31, 33), "db2", "reflect", "K3 K4"),
        ((1, 20, 17), "db4", "symmetric", "K3 K4"),
        ((1, 19, 20), "haar", "zero", "K3 K4"),
        ((1, 18, 18), "bior2.2", "constant", "K3 K4"),
        # 102 taps on 37 samples: the circular reads wrap several periods
        ((1, 37, 40), "coif17", "periodization", "K3 K4"),
    ],
)
def test_cuda_glue_matches_jax(model_kernels, shape, wavelet, mode, used):
    x = np.random.RandomState(4).randn(*shape)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode=mode, level=2)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode=mode, level=2)
    flat_w = [want[0]] + [b for t in want[1:] for b in t]
    flat_g = [got[0]] + [b for t in got[1:] for b in t]
    for g, w in zip(flat_g, flat_w):
        _close(g, w, 1e-12)
    rec_mode = mode if mode in ("periodic", "periodization") else None
    want_rec = jptwt.waverec2(want, wavelet, mode=rec_mode)
    _close(tptwt.waverec2(got, wavelet, mode=rec_mode), want_rec, 1e-12)
    assert {k for k, v in model_kernels.items() if v} == set(used.split())


def test_kernel_wrappers_refuse_grad(model_kernels):
    """On the kernel path a data tensor that requires grad gets its
    gradient from the VJP kernels; a filter that requires grad gets its
    own from KT on K3 (one launch, against the plain version) and raises
    on the fused K1 instead of falling back to the plain version."""
    x = torch.randn(1, 16, 16, dtype=torch.float64, requires_grad=True)
    dl, dh, _, _ = _banks("db2", np.float64)
    out = t2.pallas_dwt_axis(x, -1, dl, dh, "reflect")
    (grad,) = torch.autograd.grad(out.sum(), x)
    want = t2.dwt_axis_vjp_plain(x, -1, dl, dh, "reflect", torch.ones_like(out))
    _close(grad, want.numpy(), 1e-12)
    bands = t2d.fused2_dwt_level(x, dl, dh, "periodization")
    (grad,) = torch.autograd.grad(sum(b.sum() for b in bands), x)
    want = t2d.dwt2_level_vjp_plain(
        x, dl, dh, "periodization", [torch.ones_like(b) for b in bands]
    )
    _close(grad, want.numpy(), 1e-12)
    # K3's VJP is a K4 launch, K1's a K2 launch
    assert model_kernels["K4"] == 1 and model_kernels["K2"] == 1
    learn = torch.tensor(dl, requires_grad=True)
    out = t2.pallas_dwt_axis(x.detach(), -1, learn, dh, "reflect")
    (grad,) = torch.autograd.grad(out.sum(), learn)
    want, _ = t2.dwt_axis_tap_grad_plain(x, -1, dl, dh, "reflect", torch.ones_like(out))
    _close(grad, want.numpy(), 1e-12)
    assert model_kernels["KT"] == 1 and model_kernels["K4"] == 1
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t2d.fused2_dwt_level(x.detach(), learn, dh, "periodization")


def test_plain_path_carries_gradients():
    """On the CPU the plain versions are autograd-transparent, filters too."""
    w = tptwt.RegistryWavelet("db2")
    bank = [torch.tensor(f, dtype=torch.float64, requires_grad=True) for f in w.filter_bank]
    x = torch.randn(1, 12, 10, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_()

    def loss(inp, *filters):
        coeffs = tptwt.wavedec2(inp, tuple(filters), mode="reflect", level=2)
        rec = tptwt.waverec2(coeffs, tuple(filters))
        return (rec**2).sum() + sum((b**2).sum() for t in coeffs[1:] for b in t)

    assert torch.autograd.gradcheck(loss, (x, *bank))
