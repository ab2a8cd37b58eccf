"""The tiles of ``csrc/axis.cu`` (K3, K4 and their VJP instances), block by
block in numpy, against the operator form and the JAX package.

``tile_analysis`` and ``tile_synthesis`` replay the two kernels on the
CPU with their own index rules: the tile plan (balanced tiles along the
axis, a run of 64 or 32 columns of a middle axis or 16 rows of the last
axis, the shared memory each block reserves), each block's staging
through the mode's source map into a flat shared-memory array (the last
axis split into even and odd planes; K4's band rows of every pair), the
four slots of each thread with the addresses the kernels read, the fold
of K3's VJP (after the tap loop, each output within ``reach`` of either
end adds the extended positions outside the axis that map onto it,
computed from staged strips of the first and last band rows), and the
writes.  Shared memory starts as NaN, so a read of an element no
block staged shows in the result; every output must be written exactly
once.  They compute in float64 whatever the plan's item size, so both
plans are held to 1e-12 against the operator form (``_model_launch`` of
``tests/test_torch_kernels.py``) at every launch.

Through the port's own glue (the autograd Functions of ``ops/_pallas2``
with this model as the launch), K3, K4 (one and two pairs) and both VJP
instances are held against the JAX package's ``pallas_dwt_axis`` /
``pallas_idwt_axis`` in Pallas interpret mode and ``jax.vjp`` through
them: every mode including ``valid``, odd and even lengths, middle and
last axes, haar, db4, and coif17 on a 37-sample axis (its reads wrap the
axis several times); float32 within 2e-5, float64 within 1e-10, and the
float64 adjoint identity within 1e-12 of ``|Kx||y|``.  The kernels
themselves run on the card in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _axis_source, _banks, _model_launch

from ptwt_tpu.ops import _pallas2 as j2
from ptwt_tpu.ops._dispatch import dwt_axis as j_dwt_axis
from ptwt_tpu.ops._dispatch import idwt_axis as j_idwt_axis
from ptwt_tpu.wavelets import Wavelet, wavelist
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d
from _torch_one_thread import one_torch_thread  # noqa: F401

# the constants of csrc/axis.cu and csrc/common.cuh
MAX_TAPS = 128
THREADS = 256
SLOTS = 4
ROWS = 16
PLANE_PAD_BYTES = 64
SMEM_MAX = 232448
INT = 4
WRAP, WRAP_ZERO = 4, 5  # the circular mode codes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _balance(length: int, t_max: int, even: bool) -> tuple[int, int]:
    tiles = _cdiv(length, t_max)
    t = _cdiv(length, tiles)
    if even:
        t += t & 1
    return t, _cdiv(length, t)


def _run_of(inner: int, item: int) -> int:
    c = 1
    while c < 256 // item and c < inner:
        c <<= 1
    return c


def plan_analysis(outer: int, m: int, inner: int, tp: int, item: int) -> dict:
    """``plan_analysis`` of ``csrc/axis.cu``; ``smem`` in bytes."""
    if inner == 1:
        run = ROWS
        runs = _cdiv(outer, run)
        t, tiles = _balance(m, 1024 // item, False)
        span = (t + tp - 1 + 1) & ~1
        plane = run * span + PLANE_PAD_BYTES // item
        smem = item * (plane + run * span) + INT * 2 * span
        return dict(last=True, t=t, tiles=tiles, run=run, span=span, plane=plane,
                    runs=runs, blocks=runs * tiles, smem=smem)
    run = _run_of(inner, item)
    runs = _cdiv(inner, run)
    t, tiles = _balance(m, 16384 // item // run, False)
    span = 2 * (t + tp - 1)
    smem = item * span * run + INT * span
    return dict(last=False, t=t, tiles=tiles, run=run, span=span, plane=0,
                runs=runs, blocks=outer * tiles * runs, smem=smem)


def plan_synthesis(outer: int, out_len: int, inner: int, tp: int, groups: int, item: int) -> dict:
    """``plan_synthesis`` of ``csrc/axis.cu``; ``smem`` in bytes."""
    if inner == 1:
        run = ROWS
        runs = _cdiv(outer, run)
        t, tiles = _balance(out_len, 2048 // item // groups, True)
        blocks = runs * tiles
    else:
        run = _run_of(inner, item)
        runs = _cdiv(inner, run)
        t, tiles = _balance(out_len, 32768 // item // (run * groups), True)
        blocks = outer * tiles * runs
    span = t // 2 + tp
    smem = item * 2 * groups * span * run + INT * span
    return dict(last=inner == 1, t=t, tiles=tiles, run=run, span=span, runs=runs,
                blocks=blocks, smem=smem)


def _taps(vals, n_taps):
    """The kernel-parameter bank: ``n_taps`` taps, zeros up to 128."""
    out = np.zeros(MAX_TAPS)
    out[:n_taps] = np.asarray(vals, dtype=np.float64)[:n_taps]
    return out


def _block(blk: int, plan: dict) -> tuple[int, int, int]:
    """(tile along the axis, outer index, first column or row) of a block."""
    if plan["last"]:
        return blk % plan["tiles"], 0, blk // plan["tiles"] * plan["run"]
    rest = blk // plan["runs"]
    return rest % plan["tiles"], rest // plan["tiles"], (blk - rest * plan["runs"]) * plan["run"]


def _slot_groups(slots: int):
    """Each thread's groups of four slots: ``(base, [slot or -1] * 4)`` per
    thread and group, slots past the tile as -1."""
    for tid in range(THREADS):
        for base in range(tid, slots, SLOTS * THREADS):
            yield tid, [e if e < slots else -1 for e in (base + p * THREADS for p in range(SLOTS))]


def tile_analysis(x, lo, hi, n_taps, outer, n, period, m, inner, pad, mode, item):
    """K3 (``analysis_axis_kernel``) block by block: ``[outer, n, inner]``
    -> ``[2, outer, m, inner]``."""
    wraps = mode in (WRAP, WRAP_ZERO)
    assert 1 <= n_taps <= MAX_TAPS and min(outer, inner, n, m) >= 1 and pad >= 0
    assert 0 <= mode <= 5 and (not wraps or period >= n)
    fl, fh = _taps(lo, n_taps), _taps(hi, n_taps)
    tp = (n_taps + 1) // 2
    plan = plan_analysis(outer, m, inner, tp, item)
    assert plan["smem"] <= SMEM_MAX
    last, run, span, plane = plan["last"], plan["run"], plan["span"], plan["plane"]
    xs = np.asarray(x, dtype=np.float64).reshape(outer, n, inner)
    out = np.zeros((2, outer, m, inner))
    written = np.zeros(out.shape, dtype=int)
    region = plane + run * span if last else span * run
    for blk in range(plan["blocks"]):
        tile_i, o, lead = _block(blk, plan)
        i0 = tile_i * plan["t"]
        n_out = min(plan["t"], m - i0)
        nrun = min(run, (outer if last else inner) - lead)
        wins = 2 * (n_out + tp - 1)
        assert wins <= (2 * span if last else span)
        src = _axis_source(2 * i0 - pad + np.arange(wins), n, period, mode)
        smem = np.full(region, np.nan)
        if last:
            rows = lead + np.arange(nrun)
            vals = np.where(src >= 0, xs[rows][:, np.maximum(src, 0), 0], 0.0)  # [nrun, wins]
            w = np.arange(wins)
            dst = (w & 1) * plane + np.arange(nrun)[:, None] * span + (w >> 1)
        else:
            c = np.arange(run)
            ok = (src[:, None] >= 0) & (c[None, :] < nrun)
            vals = np.where(ok, xs[o][np.maximum(src, 0)][:, np.minimum(lead + c, inner - 1)], 0.0)
            dst = np.arange(wins)[:, None] * run + c[None, :]
        assert len(set(dst.ravel().tolist())) == dst.size, "two staged elements share a slot"
        smem[dst] = vals
        slots = (nrun if last else run) * n_out
        step, odd = (1, plane) if last else (2 * run, run)
        cols = n_out if last else run
        for tid, group in _slot_groups(slots):
            at = []
            for e in group:
                r, c = divmod(max(e, 0), cols)
                if e < 0:
                    r, c = 0, (0 if last else tid & (run - 1))
                at.append(r * span + c if last else 2 * r * run + c)
            at = np.array(at)
            idx = at[:, None] + step * np.arange(tp)[None, :]  # [4, tp] even reads
            assert idx.max() + odd < region
            ve, vo = smem[idx], smem[idx + odd]
            lo_v = (ve * fl[0 : 2 * tp : 2] + vo * fl[1 : 2 * tp : 2]).sum(axis=1)
            hi_v = (ve * fh[0 : 2 * tp : 2] + vo * fh[1 : 2 * tp : 2]).sum(axis=1)
            for p, e in enumerate(group):
                if e < 0:
                    continue
                r, c = divmod(e, cols)
                if last:
                    key = (lead + r, i0 + c, 0)
                elif c < nrun:
                    key = (o, i0 + r, lead + c)
                else:
                    continue
                out[(0, *key)], out[(1, *key)] = lo_v[p], hi_v[p]
                written[(0, *key)] += 1
                written[(1, *key)] += 1
    assert (written == 1).all(), "a band position was not written exactly once"
    assert np.isfinite(out).all(), "an output read shared memory that was never staged"
    return out


def _fold_plan(n_taps, m, out_len, off):
    """The fold's geometry in ``csrc/axis.cu``: the positions outside the
    axis, and the band rows the strips hold (``head`` from the start, the
    rest from the end, or all ``m``)."""
    p_end = 2 * (m - 1) + n_taps - 1 - off
    outside = off + max(p_end - out_len + 1, 0)
    head = min(((off - 1) >> 1) + 1 if off > 0 else 0, m)
    tail = m - max((out_len + off - n_taps + 2) >> 1, 0) if p_end >= out_len else 0
    return outside, head, min(head + tail, m)


def _fold_sum(u, st_lo, st_hi, srcx, fl, fh, m, n_taps, off, out_len, head, strip):
    """One entry of the fold's table: ``y[p]`` summed over the positions
    outside the axis whose source is ``u``, read from the strips."""
    acc = 0.0
    for x in np.flatnonzero(srcx == u):
        f = x if x < off else out_len + x
        for k in range(max(f & 1, f - 2 * (m - 1)), min(n_taps - 1, f) + 1, 2):
            q = (f - k) >> 1
            assert q < head or q >= m - strip + head, "a band row the strips do not hold"
            j = q if q < head else q - m + strip
            acc += fl[k] * st_lo[j] + fh[k] * st_hi[j]
    return acc


def tile_synthesis(bands, rl, rh, n_taps, outer, m, out_len, inner, off, circ, fold, period, item):
    """K4 (``synthesis_axis_kernel``) block by block: ``G`` (lo, hi) pairs
    of ``[outer, m, inner]`` -> ``[G, outer, out_len, inner]``; ``fold``
    makes it K3's VJP."""
    groups = len(bands)
    wraps = fold in (WRAP, WRAP_ZERO)
    assert 1 <= groups <= 2 and 1 <= n_taps <= MAX_TAPS and min(outer, inner, m, out_len) >= 1
    assert off >= 0 and 0 <= fold <= 5 and (not fold or (not circ and groups == 1))
    assert not wraps or period >= out_len
    fl, fh = _taps(rl, n_taps), _taps(rh, n_taps)
    tp = (n_taps + 1) // 2
    plan = plan_synthesis(outer, out_len, inner, tp, groups, item)
    last, run, span = plan["last"], plan["run"], plan["span"]
    p_end = 2 * (m - 1) + n_taps - 1 - off
    reach = max(off, p_end - out_len + 1) + 1
    # the fold's strips of band rows and the sources of the positions outside
    outside, head, strip = _fold_plan(n_taps, m, out_len, off) if fold else (0,) * 3
    assert plan["smem"] + item * run * 2 * strip + INT * outside <= SMEM_MAX
    srcx = _axis_source(np.array([x - off if x < off else out_len + x - off for x in range(outside)]),
                        out_len, period, fold)
    strip_rows = np.array([j if j < head else m - strip + j for j in range(strip)], dtype=int)
    nb_all = span * run
    bs = [[np.asarray(b, dtype=np.float64).reshape(outer, m, inner) for b in pair] for pair in bands]
    out = np.zeros((groups, outer, out_len, inner))
    written = np.zeros(out.shape, dtype=int)
    folded = np.zeros(out.shape, dtype=int)
    for blk in range(plan["blocks"]):
        tile_t, o, lead = _block(blk, plan)
        t0 = tile_t * plan["t"]
        n_out = min(plan["t"], out_len - t0)
        nrun = min(run, (outer if last else inner) - lead)
        s0 = (t0 + off) >> 1
        np_ = ((t0 + n_out - 1 + off) >> 1) - s0 + 1
        nb = np_ + tp - 1
        assert nb <= span
        q = s0 - tp + 1 + np.arange(nb)
        src = np.mod(q, m) if circ else np.where((q >= 0) & (q < m), q, -1)
        smem = np.full(2 * groups * nb_all, np.nan)
        for gb in range(2 * groups):
            band = bs[gb >> 1][gb & 1]
            if last:
                rows = lead + np.arange(nrun)
                vals = np.where(src >= 0, band[rows][:, np.maximum(src, 0), 0], 0.0)  # [nrun, nb]
                dst = gb * nb_all + np.arange(nrun)[:, None] * span + np.arange(nb)[None, :]
            else:
                c = np.arange(run)
                ok = (src[:, None] >= 0) & (c[None, :] < nrun)
                vals = np.where(ok, band[o][np.maximum(src, 0)][:, np.minimum(lead + c, inner - 1)], 0.0)
                dst = gb * nb_all + np.arange(nb)[:, None] * run + c[None, :]
            smem[dst] = vals
        # the fold's zones: A [t0, t0 + za) and B [b0, b0 + zb)
        za = max(0, min(t0 + n_out, reach) - t0) if fold else 0
        b0 = max(t0 + za, out_len - reach)
        zb = max(0, t0 + n_out - b0) if fold else 0
        slots = (nrun if last else run) * np_
        step = 1 if last else run
        cols = np_ if last else run
        for tid, group in _slot_groups(slots):
            at = []
            for e in group:
                r, c = divmod(max(e, 0), cols)
                if e < 0:
                    r, c = 0, (0 if last else tid & (run - 1))
                at.append(r * span + c + tp - 1 if last else (r + tp - 1) * run + c)
            idx = np.array(at)[:, None] - step * np.arange(tp)[None, :]  # [4, tp]
            assert idx.min() >= 0 and idx.max() < nb_all
            for p, e in enumerate(group):
                if e < 0:
                    continue
                r, c = divmod(e, cols)
                pair, col = (c, 0) if last else (r, c)
                if not last and col >= nrun:
                    continue
                t = 2 * (s0 + pair) - off
                lane = lead + r if last else lead + col
                for g in range(groups):
                    vl, vh = smem[2 * g * nb_all + idx[p]], smem[(2 * g + 1) * nb_all + idx[p]]
                    vals = [
                        (fl[0 : 2 * tp : 2] * vl + fh[0 : 2 * tp : 2] * vh).sum(),
                        (fl[1 : 2 * tp : 2] * vl + fh[1 : 2 * tp : 2] * vh).sum(),
                    ]
                    for par, v in enumerate(vals):
                        u = t + par
                        if not t0 <= u < t0 + n_out:
                            continue
                        key = (g, lane, u, 0) if last else (g, o, u, lane)
                        out[key] = v
                        written[key] += 1
        # after the tap loop: each zone output adds its fold sum once
        for r in range(nrun):
            b_lo = bs[0][0][lead + r, :, 0] if last else bs[0][0][o, :, lead + r]
            b_hi = bs[0][1][lead + r, :, 0] if last else bs[0][1][o, :, lead + r]
            for zi in range(za + zb):
                u = t0 + zi if zi < za else b0 + zi - za
                key = (0, lead + r, u, 0) if last else (0, o, u, lead + r)
                assert written[key] == 1, "the fold adds to an output before it is written"
                out[key] += _fold_sum(u, b_lo[strip_rows], b_hi[strip_rows], srcx, fl, fh, m, n_taps,
                                      off, out_len, head, strip)
                folded[key] += 1
    assert (written == 1).all(), "an output was not written exactly once"
    assert folded.max() <= 1, "an output was folded twice"
    if fold:
        # every output a position outside the axis maps onto was folded
        targets = set(srcx[srcx >= 0].tolist())
        assert all(folded[0, :, u].all() for u in targets), "an output the fold reaches was not folded"
    assert np.isfinite(out).all(), "an output read shared memory that was never staged"
    return out


def _tile_launch(kernel, entry, device, dtype, *a):
    """``_kernels.launch`` with K3/K4 replayed by the tile model, each launch
    also held against the operator form at 1e-12; other entries run the
    operator-form model."""
    if entry not in ("ptwt_analysis_axis", "ptwt_synthesis_axis"):
        return _model_launch(kernel, entry, device, dtype, *a)
    item = torch.empty((), dtype=dtype).element_size()
    if entry == "ptwt_analysis_axis":
        x, out, *rest = a
        res = tile_analysis(x.double().numpy(), *rest, item)
    else:
        lo0, hi0, lo1, hi1, groups, out = a[:6]
        pairs = [(lo0, hi0), (lo1, hi1)][:groups]
        res = tile_synthesis([[b.double().numpy() for b in pr] for pr in pairs], *a[6:], item)
    want = out.new_empty(out.shape, dtype=torch.float64)
    args = [t.double() if isinstance(t, torch.Tensor) else t for t in a]
    args[1 if entry == "ptwt_analysis_axis" else 5] = want
    _model_launch(kernel, entry, device, torch.float64, *args)
    _kernels.LAUNCHES[kernel] -= 1
    np.testing.assert_allclose(res.reshape(want.shape), want.numpy(), atol=1e-12, rtol=0)
    out.copy_(torch.from_numpy(res).reshape(out.shape))
    _kernels.LAUNCHES[kernel] += 1


@pytest.fixture
def tile_kernels(monkeypatch):
    """Send CPU tensors down the CUDA glue, K3/K4 on the tile model."""
    monkeypatch.setattr(_kernels, "launch", _tile_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    for module in (t2, t2d, t6, t7, t8):
        monkeypatch.setattr(module, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# the tile model against the operator form: every instance, both plans
# ---------------------------------------------------------------------------

AXIS_MODES = ["zero", "reflect", "periodic", "symmetric", "constant", "periodization", "valid"]


def _crop(mode: str, n_taps: int, n: int, m: int) -> tuple[int, int]:
    """The synthesis crop that rebuilds ``n`` samples from ``m``."""
    if mode == "periodization":
        return 0, 2 * m - n
    if mode == "valid":
        return 0, 0
    p = (2 * n_taps - 3) // 2
    return p, 2 * (m - 1) + n_taps - 2 * p - n + p


TAPS = {"haar": 2, "db4": 8, "coif17": 102}
SWEEP = [
    # (wavelet, shape, axis): a middle axis with a ragged run of columns,
    # the last axis with a ragged run of rows, odd and even lengths, more
    # than one tile along the axis, and coif17 (102 taps) on 37 samples
    ("haar", (3, 71, 5), -2),
    ("haar", (19, 300), -1),
    ("db4", (2, 66, 70), -2),
    ("db4", (2, 67, 3), -1),
    ("db4", (17, 600), -1),
    ("coif17", (2, 37, 3), -2),
    ("coif17", (3, 37), -1),
]


@pytest.mark.parametrize("item", [4, 8], ids=["f32plan", "f64plan"])
@pytest.mark.parametrize(
    "wavelet,shape,axis,mode",
    # valid mode needs an axis at least as long as the filter
    [(w, sh, ax, m) for w, sh, ax in SWEEP for m in AXIS_MODES if m != "valid" or sh[ax] >= TAPS[w]],
)
def test_tile_model_matches_operator_form(tile_kernels, wavelet, shape, axis, mode, item):
    """K3 and K4 (two pairs on the last axis) and both VJP instances, each
    launch of the glue replayed by the tile model and held against the
    operator form at 1e-12 (inside ``_tile_launch``)."""
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    n = shape[axis]
    dtype = torch.float32 if item == 4 else torch.float64
    rng = np.random.RandomState(sum(shape) + item)
    x = torch.from_numpy(rng.randn(*shape)).to(dtype).requires_grad_()
    out = t2.pallas_dwt_axis(x, axis, dl, dh, mode)
    torch.autograd.grad(out, x, torch.from_numpy(rng.randn(*out.shape)).to(dtype))
    lo, hi = (b.detach().requires_grad_() for b in out)
    pairs = ((lo, hi), (hi, lo)) if axis == -1 else ((lo, hi),)
    crop = _crop(mode, len(dl), n, lo.shape[axis])
    rec = t2.pallas_idwt_axis([p[0] for p in pairs], [p[1] for p in pairs], axis, rl, rh, *crop, mode)
    torch.autograd.grad(rec, (lo, hi), torch.from_numpy(rng.randn(*rec.shape)).to(dtype))
    assert tile_kernels["K3"] == 2 and tile_kernels["K4"] == 2


def _registry_lengths():
    return sorted({len(Wavelet(name).dec_lo) for name in wavelist(kind="discrete")})


def test_every_registry_length_fits():
    """Every bank of the registry (2 to 102 taps) and the longest the
    kernels take (128) fits each plan, both dtypes, one or two pairs, and
    K3's VJP with the strips of its fold."""
    lengths = _registry_lengths()
    assert lengths[0] == 2 and lengths[-1] == 102
    largest = 0
    for n_taps in [*lengths, MAX_TAPS]:
        tp = (n_taps + 1) // 2
        off = (2 * n_taps - 3) // 2
        n = 1030
        m = (n + 2 * off + n % 2 - n_taps) // 2 + 1
        outside, _, strip = _fold_plan(n_taps, m, n, off)
        for item in (4, 8):
            for inner in (1, 3, 1024):
                assert plan_analysis(16, 515, inner, tp, item)["smem"] <= SMEM_MAX
                for groups in (1, 2):
                    assert plan_synthesis(16, n, inner, tp, groups, item)["smem"] <= SMEM_MAX
                plan = plan_synthesis(16, n, inner, tp, 1, item)
                fold = plan["smem"] + item * plan["run"] * 2 * strip + INT * outside
                largest = max(largest, fold)
    assert largest == 128_472 <= SMEM_MAX


def test_headline_plans():
    """The reflect level 1 of the headline (db4, float32): K3 along -2 on
    [16, 1024, 1024] and along -1 on [2, 16, 515, 1024], the two-pair K4
    along -1 and the one-pair K4 along -2; six blocks share an SM."""
    tp = 4
    k3_mid = plan_analysis(16, 515, 1024, tp, 4)
    assert (k3_mid["t"], k3_mid["tiles"], k3_mid["run"]) == (58, 9, 64)
    k3_last = plan_analysis(2 * 16 * 515, 515, 1, tp, 4)
    assert (k3_last["t"], k3_last["tiles"], k3_last["run"]) == (172, 3, 16)
    k4_last = plan_synthesis(16 * 515, 1024, 1, tp, 2, 4)
    assert (k4_last["t"], k4_last["tiles"]) == (256, 4)
    k4_mid = plan_synthesis(16, 1024, 1024, tp, 1, 4)
    assert (k4_mid["t"], k4_mid["tiles"], k4_mid["run"]) == (128, 8, 64)
    for plan in (k3_mid, k3_last, k4_last, k4_mid):
        assert 6 * plan["smem"] <= 228 * 1024


# ---------------------------------------------------------------------------
# through the port's glue against the JAX package (Pallas interpret mode)
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _adjoint(outs, cts, ins, grads):
    """``|<K x, y> - <x, K^T y>|`` relative to ``|K x| |y|``."""
    outs, cts, ins, grads = ([t.detach() for t in ts] for ts in (outs, cts, ins, grads))
    lhs = sum(float((o * c).sum()) for o, c in zip(outs, cts))
    rhs = sum(float((i * g).sum()) for i, g in zip(ins, grads))
    scale = (sum(float((o**2).sum()) for o in outs) * sum(float((c**2).sum()) for c in cts)) ** 0.5
    return abs(lhs - rhs) / scale


GLUE = [
    # every mode twice: float32 on a middle axis of odd length with one
    # pair, float64 on the last axis of even length with two pairs (and
    # the adjoint identity); coif17 on 37 samples in float64
    *[(m, "db4", (3, 37, 5), -2, np.float32) for m in AXIS_MODES],
    *[(m, "haar" if m == "valid" else "db4", (3, 40), -1, np.float64) for m in AXIS_MODES],
    ("reflect", "coif17", (2, 37), -1, np.float64),
    ("periodization", "coif17", (2, 37, 3), -2, np.float64),
]


@pytest.mark.parametrize("mode,wavelet,shape,axis,dtype", GLUE)
def test_tile_glue_matches_jax(tile_kernels, mode, wavelet, shape, axis, dtype):
    """K3 and its VJP (K4's fold instance), K4 and its VJP (K3,
    zero-bounded) through the autograd Functions on the tile model,
    against the JAX Pallas K3/K4 and ``jax.vjp`` through them."""
    wraps_twice = (wavelet, mode) == ("coif17", "periodization")
    j_dwt, j_idwt = (j_dwt_axis, j_idwt_axis) if wraps_twice else (j2.pallas_dwt_axis, j2.pallas_idwt_axis)
    f64 = dtype == np.float64
    tol = 1e-10 if f64 else 2e-5
    dl, dh, rl, rh = _banks(wavelet, dtype)
    rng = np.random.RandomState(sum(shape) + len(dl))
    x = rng.randn(*shape).astype(dtype)

    (jlo, jhi), vjp = jax.vjp(lambda z: j_dwt(z, axis, dl, dh, mode), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = t2.pallas_dwt_axis(xt, axis, dl, dh, mode)
    _close(out[0], jlo, tol)
    _close(out[1], jhi, tol)
    ct = rng.randn(*out.shape).astype(dtype)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    _close(grad, vjp((jnp.asarray(ct[0]), jnp.asarray(ct[1])))[0], tol)
    assert tile_kernels["K3"] == 1 and tile_kernels["K4"] == 1
    if f64:
        assert _adjoint([out], [torch.from_numpy(ct)], [xt], [grad]) <= 1e-12

    crop = _crop(mode, len(dl), shape[axis], out.shape[axis])
    lo, hi = (torch.from_numpy(np.array(b)).requires_grad_() for b in (jlo, jhi))
    pairs = ((lo, hi), (hi, lo)) if f64 else ((lo, hi),)

    def j_synthesis(a, b):
        pr = ((a, b), (b, a)) if f64 else ((a, b),)
        return jnp.stack([j_idwt(p, q, axis, rl, rh, *crop, mode) for p, q in pr])

    want, rvjp = jax.vjp(j_synthesis, jlo, jhi)
    rec = t2.pallas_idwt_axis([p[0] for p in pairs], [p[1] for p in pairs], axis, rl, rh, *crop, mode)
    _close(rec, want, tol)
    if mode != "valid":
        _close(rec[0], x, 10 * tol)
    ct = rng.randn(*rec.shape).astype(dtype)
    grads = torch.autograd.grad(rec, (lo, hi), torch.from_numpy(ct))
    for g, w in zip(grads, rvjp(jnp.asarray(ct))):
        _close(g, w, tol)
    assert tile_kernels["K3"] == 2 and tile_kernels["K4"] == 2
    if f64:
        assert _adjoint([rec], [torch.from_numpy(ct)], [lo, hi], grads) <= 1e-12
