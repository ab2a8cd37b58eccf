"""KT's tiles (``csrc/axis.cu``: ``tap_grad_kernel`` and
``tap_reduce_kernel``), block by block in numpy, against KT's plain
versions.

``replay_taps`` runs the kernel's own index rules on the CPU: the tile
plan (``plan_taps``: the tap chunk K, one warp per chunk, the tile of
``t`` band positions whose two stages fit the warp's budget), each
block's equal, contiguous range of the flattened (lane group, j)
positions and its walk over tiles (a range starts afresh at the block's
first tile and at each new lane group, where the K - 2 leading window
positions are staged too; elsewhere the window registers carry over),
the staging of each tile through the mode's source map into a flat
shared-memory stage that starts as NaN, each lane's ring of K window
registers and its 2K accumulators, the butterfly over a warp's lanes and
the fixed tree over the blocks' rows.  Every staged element carries a
tag (its row, column and position), so a register that holds the wrong
position, or a read of an element no tile staged, fails; every
``(row, j, column, tap)`` product must be summed exactly once.  The
result is held to the plain versions in float64 at 1e-12 of the largest
entry, through the port's glue (``_tap_grad_kernel`` with the replay as
the launch), for K3's taps and K4's with one and two pairs, every mode
code, middle and last axes, banks of 2 to 128 taps and three grids.
The kernel itself runs on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 17.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_kernels import _axis_source, _model_launch

from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas2 as t2
from _torch_one_thread import one_torch_thread  # noqa: F401

_AXIS_CU = Path(t2.__file__).resolve().parent.parent / "csrc" / "axis.cu"


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", _AXIS_CU.read_text()).group(1))


# the constants of csrc/axis.cu, and the H100's limits per SM
TAP_WARP_SMEM = _define("TAP_WARP_SMEM")
LANES = _define("TAP_LANES")
SMEM_MAX = _define("AXIS_SMEM_MAX")
SM_SMEM = 228 * 1024  # shared memory of an SM, 1 KB of it reserved per block
SM_BLOCKS = 32
SM_SMS = 132
THREADS = 256  # PTWT_THREADS: the reduction's block
_LINE = 10**7  # tag = line * _LINE + position + _OFF
_OFF = 10**6


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tap_chunk(n_taps: int) -> int:
    return 4 if n_taps <= 4 else 8 if n_taps <= 8 else 12 if n_taps <= 12 else 16


def _stage(last: bool, t: int, kc: int, item: int) -> dict:
    """``tap_stage``: a stage's window and band tiles, and both stages' bytes."""
    vw = 16 // item
    if last:
        win, band = _cdiv(2 * t + kc - 2 + 2 * vw, vw) * vw, _cdiv(t + 2 * vw, vw) * vw
    else:
        win, band = LANES * (2 * t + kc - 2), LANES * t
    return {"t": t, "win": win, "band": band, "smem": 2 * item * (win + 2 * band)}


def plan_taps(rows: int, m: int, inner: int, n_taps: int, item: int) -> dict:
    """``plan_taps`` of ``csrc/axis.cu``, with the shared memory of a block."""
    last = inner == 1
    k = tap_chunk(n_taps)
    u = k // 2
    chunks = _cdiv(n_taps, k)
    kc = chunks * k
    groups = rows if last else rows * _cdiv(inner, LANES)
    budget = TAP_WARP_SMEM * chunks
    plan = {"last": last, "k": k, "chunks": chunks, "groups": groups, "total": groups * m, "lane": 0}
    if last:
        lane = 1
        while _stage(True, LANES * (lane + 2), kc, item)["smem"] <= budget:
            lane += 2
        tiles = _cdiv(m, LANES * lane)
        plan["lane"] = _cdiv(m, LANES * tiles) | 1
        return {**plan, **_stage(True, LANES * plan["lane"], kc, item)}
    t_cap = _cdiv(m, u) * u
    t = u
    while t + u <= t_cap and _stage(False, t + u, kc, item)["smem"] <= budget:
        t += u
    return {**plan, **_stage(False, t, kc, item)}


def blocks_per_sm(plan: dict) -> int:
    """Blocks an SM holds by shared memory and the block limit (registers,
    which ``nvcc -Xptxas -v`` reports, may hold fewer)."""
    return min(SM_BLOCKS, 2048 // (LANES * plan["chunks"]), SM_SMEM // (plan["smem"] + 1024))


def tap_grid(plan: dict, resident: int, cap: int) -> int:
    return min(cap, resident, _cdiv(plan["total"], plan["t"]))


def tap_tiles(f0: int, f1: int, m: int, t: int, carry: int):
    """A block's tiles ``(s, j0, n, h0)``: ``first_tap_tile`` /
    ``next_tap_tile``; ``carry`` the window positions the registers carry
    from tile to tile (K - 2 on a middle axis, 0 on the last)."""
    s, j0 = divmod(f0, m)
    n = min(t, m - j0, f1 - f0)
    h0 = 0
    while True:
        yield s, j0, n, h0
        f = s * m + j0 + n
        if f >= f1:
            return
        if j0 + n == m:
            s, j0, h0 = s + 1, 0, 0
        else:
            j0, h0 = j0 + n, carry
        n = min(t, m - j0, f1 - f)


def _stage_mid(plan, tile, x, los, his, outer, n, period, m, inner, pad, mode, kc):
    """A middle axis's stage (values and tags), NaN and -1 where nothing
    was staged: the window [position][32 columns], then each band tile
    [j][32 columns]."""
    s, j0, nt, h0 = tile
    size = plan["win"] + 2 * plan["band"]
    val, tag = np.full(size, np.nan), np.full(size, -1, dtype=np.int64)
    span = 2 * nt + kc - 2 - h0
    pos = 2 * j0 - pad + h0 + np.arange(span)
    src = _axis_source(pos, n, period, mode)
    lane = np.arange(LANES)
    o, run = divmod(s, _cdiv(inner, LANES))
    c = run * LANES + lane
    live = c < inner
    cl = np.minimum(c, inner - 1)
    at = np.arange(span)[:, None] * LANES + lane[None, :]
    val[at] = np.where(live[None, :] & (src >= 0)[:, None], x[o][np.maximum(src, 0)][:, cl], 0.0)
    tag[at] = np.where(live[None, :], (o * inner + cl)[None, :] * _LINE + pos[:, None] + _OFF, -1)
    g = int(o >= outer)
    j = np.arange(nt)
    at = j[:, None] * LANES + lane[None, :]
    line = np.where(live[None, :], (o * inner + cl)[None, :] * _LINE + (j0 + j)[:, None] + _OFF, -1)
    for base, band in ((plan["win"], los[g]), (plan["win"] + plan["band"], his[g])):
        val[base + at] = np.where(live[None, :], band[o - g * outer][j0 + j][:, cl], 0.0)
        tag[base + at] = line
    return val, tag, 0, 0


def _stage_line(val, tag, base, flat, r, row_len, lines, p0, length, vec, vw, src):
    """``stage_tap_line``: ``length`` elements of row ``r`` (``row_len``
    long) of the flat array ``flat``, from position ``p0``, at ``base``:
    16 bytes a copy where ``vec`` and the aligned chunks stay inside the
    array (the run then starts ``(r row_len + p0) % vw`` in; the chunks may
    reach into the neighbouring rows), else one element a copy through
    ``src``.  Tags name x's row (``lines`` added to the array's row) and
    the position.  Returns the shift."""
    at = r * row_len + p0
    shift = at % vw
    count = _cdiv(shift + length, vw) * vw
    if vec and at - shift + count <= len(flat):
        pos = at - shift + np.arange(count)
        val[base : base + count] = flat[pos]
        tag[base : base + count] = (pos // row_len + lines) * _LINE + pos % row_len + _OFF
        return shift
    pos = p0 + np.arange(length)
    q = src(pos)
    val[base : base + length] = np.where(q >= 0, flat[r * row_len + np.maximum(q, 0)], 0.0)
    tag[base : base + length] = (r + lines) * _LINE + pos + _OFF
    return 0


def _stage_last(plan, tile, x, los, his, outer, n, period, m, inner, pad, mode, kc):
    """The last axis's stage: one row's window run, then its band runs."""
    s, j0, nt, h0 = tile
    size = plan["win"] + 2 * plan["band"]
    val, tag = np.full(size, np.nan), np.full(size, -1, dtype=np.int64)
    span = 2 * nt + kc - 2
    p0 = 2 * j0 - pad
    vw = 16 // plan["item"]
    inside = bool(plan["vec"]) and p0 >= 0 and p0 + span <= n
    sh = _stage_line(val, tag, 0, x.reshape(-1), s, n, 0, p0, span, inside, vw,
                     lambda q: _axis_source(q, n, period, mode))
    g = int(s >= outer)
    for base, bands in ((plan["win"], los), (plan["win"] + plan["band"], his)):
        bsh = _stage_line(val, tag, base, bands[g].reshape(-1), s - g * outer, m, g * outer, j0, nt,
                          plan["bvec"], vw, lambda q: q)
    return val, tag, sh, bsh


def replay_taps(x, los, his, n_taps, outer, n, period, m, inner, pad, mode, item, grid, vec=False, bvec=False):
    """KT on ``x`` (``[rows, n, inner]``) and the bands (``[outer, m,
    inner]`` per pair) with ``grid`` blocks (``vec``/``bvec``: the C
    entry's 16-byte staging flags): ``(partial, out, counts, carried)``,
    ``counts[row, j, column, tap]`` the times each product was summed,
    ``carried`` the tiles that carried the window over."""
    rows = x.shape[0]
    plan = {**plan_taps(rows, m, inner, n_taps, item), "item": item, "vec": vec, "bvec": bvec}
    assert plan["smem"] <= SMEM_MAX
    k, chunks = plan["k"], plan["chunks"]
    u_steps, kc, last = k // 2, chunks * k, plan["last"]
    rs = 1 if last else LANES
    lane = np.arange(LANES)
    counts = np.zeros((rows, m, inner, n_taps), dtype=np.int64)
    partial = np.zeros((grid, 2 * n_taps))
    carried = 0
    stage = _stage_last if last else _stage_mid
    for blk in range(grid):
        f0, f1 = blk * plan["total"] // grid, (blk + 1) * plan["total"] // grid
        w = np.zeros((chunks, LANES, k))
        wtag = np.full((chunks, LANES, k), -2, dtype=np.int64)
        acc = np.zeros((2, chunks, LANES, k))
        for tile in tap_tiles(f0, f1, m, plan["t"], 0 if last else k - 2) if f0 < f1 else ():
            val, tag, sh, bsh = stage(plan, tile, x, los, his, outer, n, period, m, inner, pad, mode, kc)
            s, j0, nt, h0 = tile
            carried += h0 > 0
            if last:
                j_lane = lane * plan["lane"]
                steps = np.clip(nt - j_lane, 0, plan["lane"])
                live = steps > 0
                rowi, coli = np.full(LANES, s), np.zeros(LANES, dtype=int)
                wbase, bbase = sh + 2 * j_lane, bsh + j_lane
            else:
                o, run = divmod(s, _cdiv(inner, LANES))
                c = run * LANES + lane
                live = c < inner
                j_lane, steps = np.zeros(LANES, dtype=int), np.full(LANES, nt)
                rowi, coli = np.full(LANES, o), np.minimum(c, inner - 1)
                wbase, bbase = lane, lane
            lines = (rowi * inner + coli) * _LINE
            for ch in range(chunks):
                wp = wbase + (ch * k - h0) * rs
                if h0 == 0:
                    for q in range(k - 2):
                        w[ch, :, q], wtag[ch, :, q] = val[wp + q * rs], tag[wp + q * rs]
                taps = ch * k + np.arange(k)
                keep = taps < n_taps
                for j in range(int(steps.max(initial=0))):
                    on = j < steps
                    u, jg = j % u_steps, j - j % u_steps
                    for q in (2 * u + k - 2, 2 * u + k - 1):
                        at = wp + 2 * jg * rs + q * rs
                        w[ch, on, q % k], wtag[ch, on, q % k] = val[at[on]], tag[at[on]]
                    at = [plan["win"] + f * plan["band"] + bbase + j * rs for f in (0, 1)]
                    b = [np.where(on, val[np.where(on, a_, 0)], 0.0) for a_ in at]
                    btag = [tag[np.where(on, a_, 0)] for a_ in at]
                    slots = (2 * u + np.arange(k)) % k
                    jj = j0 + j_lane + j
                    want = lines[:, None] + 2 * jj[:, None] - pad + taps[None, :] + _OFF
                    sel = live & on
                    assert (wtag[ch][:, slots] == want)[sel].all(), "a register holds the wrong position"
                    for f in (0, 1):
                        assert (btag[f] == lines + jj + _OFF)[sel].all(), "the wrong band element"
                        acc[f, ch] += np.where(sel[:, None], b[f][:, None] * w[ch][:, slots], 0.0)
                    ri, ji, ci, ti = np.broadcast_arrays(rowi[sel][:, None], jj[sel][:, None], coli[sel][:, None],
                                                         taps[keep][None, :])
                    np.add.at(counts, (ri, ji, ci, ti), 1)
        for f in (0, 1):
            for ch in range(chunks):
                for q in range(k):
                    v = acc[f, ch, :, q].copy()
                    for off in (16, 8, 4, 2, 1):
                        v = v + v[lane ^ off]
                    if ch * k + q < n_taps:
                        partial[blk, f * n_taps + ch * k + q] = v[0]
    red = np.zeros((THREADS, 2 * n_taps))
    for b in range(grid):
        red[b % THREADS] += partial[b]
    half = THREADS // 2
    while half:
        red[:half] += red[half : 2 * half]
        half //= 2
    return partial, red[0].reshape(2, n_taps), counts, carried


# ---------------------------------------------------------------------------
# the plan at the main path's shapes
# ---------------------------------------------------------------------------


def test_headline_plans():
    """Level 1 of the headline (db4, float32; K3's taps along -2 on [16,
    1024, 1024] and along -1 on [2, 16, 515, 1024]) and of d1 (db5,
    reflect, [32, 10**6]): one warp a block; along -2 tiles of 4 band
    positions of 32 columns, along -1 a row's 515 positions in three
    tiles of 7 a lane, d1's rows in tiles of 7 a lane; the tiles per block
    on 132 SMs at the blocks shared memory allows."""
    mid = plan_taps(16, 515, 1024, 8, 4)
    last = plan_taps(2 * 16 * 515, 515, 1, 8, 4)
    m1, _, _, _ = t2._analysis_plan(10**6, 10, "reflect")
    d1 = plan_taps(32, m1, 1, 10, 4)
    assert m1 == 500_004
    got = {name: (p["k"], p["chunks"], p["t"], p["smem"], blocks_per_sm(p), _cdiv(p["total"], p["t"]))
           for name, p in (("mid", mid), ("last", last), ("d1", d1))}
    assert got == {
        "mid": (8, 1, 4, 5_632, 32, 65_920),
        "last": (8, 1, 224, 7_424, 27, 37_890),
        "d1": (12, 1, 224, 7_456, 27, 71_430),
    }
    for p in (mid, last, d1):
        grid = tap_grid(p, blocks_per_sm(p) * SM_SMS, t2.TAP_BLOCKS)
        assert grid == blocks_per_sm(p) * SM_SMS <= t2.TAP_BLOCKS == SM_BLOCKS * SM_SMS
        # every block walks an equal range: its tiles differ by at most two
        per = [len(list(tap_tiles(b * p["total"] // grid, (b + 1) * p["total"] // grid, 515 if p is not d1
                                  else m1, p["t"], 0))) for b in range(0, grid, 97)]
        assert max(per) - min(per) <= 2


def test_every_length_fits():
    """Banks of 1 to 128 taps fit both dtypes and both axes."""
    for n_taps in range(1, 129):
        for item in (4, 8):
            for inner in (1, 3, 1024):
                p = plan_taps(64, 1000, inner, n_taps, item)
                assert p["smem"] <= SMEM_MAX
                if p["last"]:  # odd runs a lane
                    assert p["t"] == LANES * p["lane"] and p["lane"] % 2
                else:  # whole groups of K / 2 steps, so the window carries over
                    assert p["t"] % (p["k"] // 2) == 0
                assert p["chunks"] * LANES <= THREADS
    # eight warps share a 128-tap bank's tiles: their budget is eight warps'
    assert plan_taps(16, 515, 1024, 128, 4)["t"] == 32


# ---------------------------------------------------------------------------
# the replay through the port's glue against the plain versions
# ---------------------------------------------------------------------------


def _replay_launch(grid_of, carried_log):
    """A stand-in for ``_kernels.launch`` that replays KT on ``grid_of(plan)``
    resident blocks (the other entries on the kernel model) and appends
    each replay's carried tiles to ``carried_log``."""
    def launch(kernel, entry, device, dtype, *a):
        if entry != "ptwt_tap_grad":
            return _model_launch(kernel, entry, device, dtype, *a)
        x, lo0, hi0, lo1, hi1, groups, out, partial, cap, n_taps, outer, n, period, m, inner, pad, code = a
        assert partial.shape == (cap, 2 * n_taps) and out.dtype == torch.float64
        xs = x.numpy().astype(np.float64).reshape(-1, n, inner)
        pairs = [(lo0, hi0), (lo1, hi1)][:groups]
        los = [p[0].numpy().astype(np.float64).reshape(outer, m, inner) for p in pairs]
        his = [p[1].numpy().astype(np.float64).reshape(outer, m, inner) for p in pairs]
        item = x.element_size()
        plan = plan_taps(xs.shape[0], m, inner, n_taps, item)
        grid = tap_grid(plan, grid_of(plan), cap)
        # the C entry's 16-byte staging flags, from the same pointers
        vw = 16 // item
        bands_aligned = all(t.data_ptr() % 16 == 0 for t in (lo0, hi0, lo1, hi1))
        vec = x.data_ptr() % 16 == 0 and (inner == 1 or (inner % vw == 0 and bands_aligned))
        bvec = inner == 1 and bands_aligned
        rows, res, counts, carried = replay_taps(xs, los, his, n_taps, outer, n, period, m, inner, pad, code, item,
                                                 grid, vec, bvec)
        assert (counts == 1).all(), "a product summed other than once"
        carried_log.append(carried)
        partial[:grid] = torch.from_numpy(rows)
        out.copy_(torch.from_numpy(res))
        _kernels.LAUNCHES[kernel] += 1

    return launch


#: blocks resident on the card: one, a few (ranges cross lane groups and
#: carry the window over tiles), the H100's at the plan's shared memory
GRIDS = {"one": lambda p: 1, "seven": lambda p: 7, "h100": lambda p: blocks_per_sm(p) * SM_SMS}

MODES = ["zero", "constant", "symmetric", "reflect", "periodic", "periodization", "valid"]

#: (axis, shape): a middle axis with two runs of columns (the second
#: partly live), a middle axis narrower than a warp (both some tiles long,
#: so the window carries over), the last axis on an odd length (every run
#: staged element by element) and on an even one (runs inside the row and
#: band rows of an even length staged 16 bytes a lane)
SHAPES = [(-2, (2, 100, 40)), (-3, (45, 2, 3)), (-1, (35, 101)), (-1, (3, 1000))]


def _tap_case(mode, axis, shape, n_taps, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape)).to(dtype)
    dl, dh, rl, rh = (rng.randn(n_taps) for _ in range(4))
    ax = axis % x.ndim
    m, period, pad, code = t2._analysis_plan(x.shape[ax], n_taps, mode)
    band_shape = [m if i == ax else s for i, s in enumerate(shape)]
    ct = torch.from_numpy(rng.randn(2, *band_shape)).to(dtype)
    cases = [(lambda: t2._tap_grad_kernel(x, ax, [ct[0]], [ct[1]], n_taps, period, pad, code),
              lambda: t2.dwt_axis_tap_grad_plain(x, axis, dl, dh, mode, ct))]
    if mode != "valid":
        p = 0 if mode == "periodization" else (2 * n_taps - 3) // 2
        circular = mode == "periodization"
        for groups in (1, 2):
            los = [torch.from_numpy(rng.randn(*band_shape)).to(dtype) for _ in range(groups)]
            his = [torch.from_numpy(rng.randn(*band_shape)).to(dtype) for _ in range(groups)]
            out_len = t2.idwt_axis_plain(los[0], his[0], axis, rl, rh, p, p, mode).shape[ax]
            cot = torch.from_numpy(rng.randn(groups, *[out_len if i == ax else s
                                                        for i, s in enumerate(shape)])).to(dtype)
            per, c = (2 * m, t2._WRAP_ZERO) if circular else (out_len, t2._ZERO)
            off = p + n_taps // 2 - 1 if circular else p

            def kernel(cot=cot, los=los, his=his, per=per, c=c, off=off):
                return t2._tap_grad_kernel(cot, ax + 1, los, his, n_taps, per, off, c)

            def plain(cot=cot, los=los, his=his):
                return t2.idwt_axis_tap_grad_plain(los, his, axis, rl, rh, p, p, mode, cot)

            cases.append((kernel, plain))
    return cases


@pytest.fixture
def replay(monkeypatch):
    def use(grid_of):
        carried = []
        monkeypatch.setattr(_kernels, "launch", _replay_launch(grid_of, carried))
        monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
        monkeypatch.setattr(t2, "_on_cpu", lambda t: False)
        _kernels.reset_launch_counts()
        return carried

    yield use
    _kernels.reset_launch_counts()


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("axis,shape", SHAPES, ids=["mid", "narrow", "last", "last_even"])
@pytest.mark.parametrize("mode", MODES)
def test_replay_matches_plain(replay, mode, axis, shape, grid):
    """K3's taps and K4's (one and two pairs): db4's length, an odd 7-tap
    bank and db5's 10 taps (K = 12), every product once, within 1e-12 of
    the plain versions' largest entry."""
    carried = replay(GRIDS[grid])
    for n_taps in (8, 7, 10):
        for kernel, plain in _tap_case(mode, axis, shape, n_taps, torch.float64, n_taps):
            got, want = kernel(), torch.stack(plain()).double()
            assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    if grid == "one" and axis != -1:  # a middle axis's walk over several tiles
        assert max(carried) > 0


@pytest.mark.parametrize("n_taps", [2, 40, 128])
@pytest.mark.parametrize("axis,shape", SHAPES[::2], ids=["mid", "last"])
@pytest.mark.parametrize("mode", ["reflect", "periodization", "zero"])
def test_replay_tap_chunks(replay, mode, axis, shape, n_taps):
    """Haar (K = 4), 40 taps (three chunks of 16, three warps) and 128
    (eight): the warps share each staged tile, each carries its chunk's
    window; reflect and periodization read the short axis many times
    over."""
    replay(GRIDS["seven"])
    for kernel, plain in _tap_case(mode, axis, shape, n_taps, torch.float64, n_taps):
        got, want = kernel(), torch.stack(plain()).double()
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("mode", ["reflect", "periodization", "zero"])
def test_replay_aligned_runs(mode, item):
    """The last axis's 16-byte staging (window runs inside the row, band
    runs; shifted to the alignment) and its element-wise staging sum the
    same products, once each, for float32 and float64 plans."""
    rng = np.random.RandomState(5)
    rows, n = 6, 1000
    x = rng.randn(rows, n, 1)
    m, period, pad, code = t2._analysis_plan(n, 8, mode)
    lo, hi = rng.randn(1, rows, m, 1), rng.randn(1, rows, m, 1)
    src = _axis_source(2 * np.arange(m)[:, None] - pad + np.arange(8)[None, :], n, period, code)
    ext = np.where(src >= 0, x[:, np.maximum(src, 0), 0], 0.0)
    want = np.stack([np.einsum("rj,rjk->k", b[0, :, :, 0], ext) for b in (lo, hi)])
    vw = 16 // item
    for vec, bvec in ((False, False), (True, True)):
        for grid in (1, 4):
            _, res, counts, _ = replay_taps(x, [lo[0]], [hi[0]], 8, rows, n, period, m, 1, pad, code, item, grid,
                                            vec, bvec)
            assert (counts == 1).all()
            np.testing.assert_allclose(res, want, rtol=0, atol=1e-12 * np.abs(want).max())
