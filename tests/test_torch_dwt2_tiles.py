"""The tile plan of ``csrc/dwt2.cu`` (K1, K2 and their VJP instances), block
by block in numpy, against the operator form and the JAX package.

``tile_dwt2`` and ``tile_idwt2`` replay the two kernels on the CPU with
their own index rules: the tile table (the largest tile whose block fits
64 KB of shared memory, else the largest that fits the card), each
block's staged window (read modulo the period with the odd-axis repeat,
zero outside, or folded modulo ``half``), the parity-split passes (K1:
even and odd input columns, a W pass then an H pass; K2: pairs of output
positions that read the same band rows, an H pass into ``Z``, the clamp's
extra rows added into the last row, a W pass two outputs at a time, the
clamp's extra columns added by the thread that owns the last column).
They assert that every output is written exactly once and that no block
needs more shared memory than the kernel reserves.  They compute in
float64 whatever the plan's item size, so the float32 and float64 plans
are both held to 1e-12 against the operator form (``_model_launch`` of
``tests/test_torch_kernels.py``).

Through the port's own glue (the autograd Functions of ``ops/_pallas2d``
with this model as the launch), K1, K2 and both VJPs are held against the
JAX level route (``analysis_nd``/``synthesis_nd`` and ``jax.vjp`` through
them) and, on power-of-two shapes, against the JAX Pallas K1/K2 in
interpret mode.  The kernels themselves run on the card in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _banks, _model_launch, _std_pad

from ptwt_tpu.ops import _pallas2d as j2d
from ptwt_tpu.ops._dispatch import analysis_nd as j_analysis_nd
from ptwt_tpu.ops._dispatch import synthesis_nd as j_synthesis_nd
from ptwt_tpu.wavelets import Wavelet, wavelist
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d
from _torch_one_thread import one_torch_thread  # noqa: F401

# the constants of csrc/dwt2.cu and csrc/common.cuh
MAX_TAPS = 128
SMEM_TARGET = 64 * 1024
SMEM_MAX = 232448
ANA_TILES = (32, 16, 8)
SYN_TILES = (64, 32, 16, 8)
INT = 4


def _pick(cands, smem) -> int:
    for t in cands:
        if smem(t) <= SMEM_TARGET:
            return t
    for t in cands:
        if smem(t) <= SMEM_MAX:
            return t
    raise AssertionError("no tile fits the card's shared memory")


def ana_smem(t: int, tp: int, item: int) -> int:
    xr, xh = 2 * (t + tp - 1), t + tp - 1
    return item * (2 * xr * xh + 2 * xr * t) + INT * (xr + 2 * xh)


def syn_shape(t: int, tp: int, ext_h: int, ext_w: int) -> dict:
    ph, pw = (t + ext_h) // 2 + 1, (t + ext_w) // 2 + 1
    return {"t": t, "tp": tp, "ph": ph, "pw": pw, "br": ph + tp - 1, "bc": pw + tp - 1}


def syn_smem(s: dict, item: int) -> int:
    return item * (4 * s["br"] * s["bc"] + 2 * 2 * s["ph"] * s["bc"]) + INT * (s["br"] + s["bc"])


def _taps(vals, n_taps):
    """The kernel-parameter bank: ``n_taps`` taps, zeros up to 128."""
    out = np.zeros(MAX_TAPS)
    out[:n_taps] = np.asarray(vals, dtype=np.float64)[:n_taps]
    return out


def _source(r, period, n, circular):
    """Source index per position, -1 for a zero read."""
    if circular:
        return np.minimum(np.mod(r, period), n - 1)
    return np.where((r >= 0) & (r < n), r, -1)


def _gather(img, rows, cols):
    """``img[rows][:, cols]`` with zero where a row or column is -1."""
    out = img[np.maximum(rows, 0)][:, np.maximum(cols, 0)]
    return np.where((rows[:, None] >= 0) & (cols[None, :] >= 0), out, 0.0)


def tile_dwt2(x, lo, hi, n_taps, b, h, w, per_h, per_w, m_h, m_w, pad, circ, item):
    """K1 (``dwt2_tile_kernel``) block by block: ``[b, h, w]`` -> ``[4, b, m_h, m_w]``."""
    assert 1 <= n_taps <= MAX_TAPS and b >= 1 and min(h, w, m_h, m_w) >= 1
    assert not circ or (per_h >= h and per_w >= w)
    lo, hi = _taps(lo, n_taps), _taps(hi, n_taps)
    tp = (n_taps + 1) // 2
    t = _pick(ANA_TILES, lambda t: ana_smem(t, tp, item))
    xr, xh = 2 * (t + tp - 1), t + tp - 1
    out = np.zeros((4, b, m_h, m_w))
    written = np.zeros(out.shape, dtype=int)
    for bi in range(b):
        for i0 in range(0, m_h, t):
            for j0 in range(0, m_w, t):
                rows = _source(2 * i0 - pad + np.arange(xr), per_h, h, circ)
                cols = _source(2 * j0 - pad + np.arange(2 * xh), per_w, w, circ)
                win = _gather(x[bi], rows, cols)
                xe, xo = win[:, 0::2], win[:, 1::2]
                y = [sum(f[2 * a] * xe[:, a : a + t] + f[2 * a + 1] * xo[:, a : a + t] for a in range(tp))
                     for f in (lo, hi)]
                # (ll, lh, hl, hh): (H, W) filters (lo, lo), (hi, lo), (lo, hi), (hi, hi)
                ni, nj = min(t, m_h - i0), min(t, m_w - j0)
                for o, (fh, yw) in enumerate(((lo, y[0]), (hi, y[0]), (lo, y[1]), (hi, y[1]))):
                    band = sum(
                        fh[2 * a] * yw[2 * a : 2 * a + 2 * t : 2] + fh[2 * a + 1] * yw[2 * a + 1 : 2 * a + 2 * t : 2]
                        for a in range(tp)
                    )
                    out[o, bi, i0 : i0 + ni, j0 : j0 + nj] = band[:ni, :nj]
                    written[o, bi, i0 : i0 + ni, j0 : j0 + nj] += 1
    assert (written == 1).all(), "a band position was not written exactly once"
    return out


def _fold_index(q, half, m, circ):
    """Band rows a staged row collects, as index arrays (-1: none): every
    ``ra < m`` congruent to ``q`` modulo ``half`` (circular), else ``q``
    itself inside ``[0, m)``."""
    if not circ:
        return [np.where((q >= 0) & (q < m), q, -1)]
    first = np.mod(q, half)
    return [np.where(first + k * half < m, first + k * half, -1) for k in range(-(-m // half))]


def tile_idwt2(bands, lo, hi, n_taps, b, m_h, m_w, out_h, out_w, off_h, off_w, circ,
               half_h, half_w, per_h, per_w, item):
    """K2 (``idwt2_tile_kernel``) block by block: four ``[b, m_h, m_w]``
    bands -> ``[b, out_h, out_w]``."""
    folds = (half_h, half_w, per_h, per_w) != (m_h, m_w, out_h, out_w)
    assert 1 <= n_taps <= MAX_TAPS and b >= 1 and min(out_h, out_w, m_h, m_w) >= 1
    assert min(off_h, off_w) >= 0 and 1 <= half_h <= m_h and 1 <= half_w <= m_w
    assert per_h >= out_h and per_w >= out_w and (circ or not folds)
    lo, hi = _taps(lo, n_taps), _taps(hi, n_taps)
    tp = (n_taps + 1) // 2
    ext_h, ext_w = per_h - out_h, per_w - out_w
    t = _pick(SYN_TILES, lambda t: syn_smem(syn_shape(t, tp, ext_h, ext_w), item))
    s = syn_shape(t, tp, ext_h, ext_w)
    ph, pw, br, bc = s["ph"], s["pw"], s["br"], s["bc"]
    out = np.zeros((b, out_h, out_w))
    written = np.zeros(out.shape, dtype=int)
    for bi in range(b):
        for u0 in range(0, out_h, t):
            for v0 in range(0, out_w, t):
                s0, sc0 = (u0 + off_h) >> 1, (v0 + off_w) >> 1
                rows = _fold_index(s0 - tp + 1 + np.arange(br), half_h, m_h, circ)
                cols = _fold_index(sc0 - tp + 1 + np.arange(bc), half_w, m_w, circ)
                staged = np.array(
                    [sum(_gather(band[bi], r, c) for r in rows for c in cols) for band in bands]
                )
                # H pass: pair p reads staged row p + tp - 1 - j with taps 2j, 2j + 1
                z = np.zeros((2, 2 * ph, bc))
                for j in range(tp):
                    sl = slice(tp - 1 - j, tp - 1 - j + ph)
                    ll, lh, hl, hh = (staged[o, sl] for o in range(4))
                    for par in (0, 1):
                        k = 2 * j + par
                        z[0, par::2] += lo[k] * ll + hi[k] * lh
                        z[1, par::2] += lo[k] * hl + hi[k] * hh
                dh = (u0 + off_h) & 1
                if ext_h and u0 <= out_h - 1 < u0 + t:
                    last = out_h - 1 - u0 + dh
                    z[:, last] += z[:, last + 1 : last + 1 + ext_h].sum(axis=1)
                # W pass: output pair q of every row, two outputs per thread
                nu = min(t, out_h - u0)
                zl, zh = z[0, dh : dh + nu], z[1, dh : dh + nu]
                pairs = np.zeros((2, nu, pw))
                for j in range(tp):
                    sl = slice(tp - 1 - j, tp - 1 - j + pw)
                    for par in (0, 1):
                        pairs[par] += lo[2 * j + par] * zl[:, sl] + hi[2 * j + par] * zh[:, sl]
                v_end = min(v0 + t, out_w)
                for q in range(pw):
                    for par in (0, 1):
                        v = 2 * (sc0 + q) - off_w + par
                        if not v0 <= v < v_end:
                            continue
                        vals = pairs[par, :, q].copy()
                        if ext_w and v == out_w - 1:
                            for vx in range(out_w, per_w):
                                g = vx + off_w
                                c = (g >> 1) - sc0 + tp - 1
                                for j in range(tp):
                                    k = (g & 1) + 2 * j
                                    vals += lo[k] * zl[:, c - j] + hi[k] * zh[:, c - j]
                        out[bi, u0 : u0 + nu, v] = vals
                        written[bi, u0 : u0 + nu, v] += 1
    assert (written == 1).all(), "an output was not written exactly once"
    return out


def _tile_launch(kernel, entry, device, dtype, *a):
    """``_kernels.launch`` with K1/K2 replayed by the tile model and every
    other entry by the operator-form model."""
    if entry not in ("ptwt_dwt2", "ptwt_idwt2"):
        return _model_launch(kernel, entry, device, dtype, *a)
    item = torch.empty((), dtype=dtype).element_size()
    if entry == "ptwt_dwt2":
        x, out, *rest = a
        res = tile_dwt2(x.double().numpy(), *rest, item)
    else:
        *bands, out = a[:5]
        res = tile_idwt2([bnd.double().numpy() for bnd in bands], *a[5:], item)
    out.copy_(torch.from_numpy(res).reshape(out.shape))
    _kernels.LAUNCHES[kernel] += 1


@pytest.fixture
def tile_kernels(monkeypatch):
    """Send CPU tensors down the CUDA glue, K1/K2 on the tile model."""
    monkeypatch.setattr(_kernels, "launch", _tile_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    for module in (t2, t2d, t6, t7, t8):
        monkeypatch.setattr(module, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# the tile plan against the operator form, every instance, both plans
# ---------------------------------------------------------------------------


def _launch_args(instance, mode, n_taps, b, h, w):
    """(entry, argument tuple after the tensors) as ``ops/_pallas2d`` builds
    them for one level of a ``[b, h, w]`` image: the forward launches, K1's
    VJP (K2 with the fold) and K2's VJP (K1 zero-bounded when periodic)."""
    if mode == "periodization":
        pad = n_taps // 2 - 1
        per_h, per_w = h + h % 2, w + w % 2
        m_h, m_w = per_h // 2, per_w // 2
    else:
        pad = _std_pad(n_taps)
        per_h, per_w = h, w
        m_h, m_w = (h + 2 * pad - n_taps) // 2 + 1, (w + 2 * pad - n_taps) // 2 + 1
    circ = int(mode == "periodization")
    if instance == "K1":
        return "ptwt_dwt2", (b, h, w, per_h, per_w, m_h, m_w, pad, 1)
    if instance == "K1 VJP":
        return "ptwt_idwt2", (b, m_h, m_w, h, w, pad, pad, 1, per_h // 2, per_w // 2, per_h, per_w)
    # K2 and its VJP: the level that reconstructs the even image [h, w]
    if instance == "K2":
        return "ptwt_idwt2", (b, m_h, m_w, h, w, pad, pad, circ, m_h, m_w, h, w)
    return "ptwt_dwt2", (b, h, w, h, w, m_h, m_w, pad, circ)


def _run_both(entry, args, lo, hi, n_taps, item, seed):
    rng = np.random.RandomState(seed)
    b = args[0]
    if entry == "ptwt_dwt2":
        x = torch.from_numpy(rng.randn(b, args[1], args[2]))
        want = torch.empty((4, b, args[5], args[6]), dtype=torch.float64)
        _model_launch("K1", entry, None, torch.float64, x, want, lo, hi, n_taps, *args)
        got = tile_dwt2(x.numpy(), lo, hi, n_taps, *args, item)
    else:
        bands = [torch.from_numpy(rng.randn(b, args[1], args[2])) for _ in range(4)]
        want = torch.empty((b, args[3], args[4]), dtype=torch.float64)
        _model_launch("K2", entry, None, torch.float64, *bands, want, lo, hi, n_taps, *args)
        got = tile_idwt2([bnd.numpy() for bnd in bands], lo, hi, n_taps, *args, item)
    return got, want.numpy()


INSTANCES = [
    # (instance, mode): forward, K1's VJP with the fold (periodic; odd
    # periodization: the clamp), K2's VJP zero-bounded (periodic) or circular
    ("K1", "periodic"), ("K1", "periodization"),
    ("K2", "periodic"), ("K2", "periodization"),
    ("K1 VJP", "periodic"), ("K1 VJP", "periodization"),
    ("K2 VJP", "periodic"), ("K2 VJP", "periodization"),
]
SHAPES = {
    # smaller than one tile; ragged last tiles with h != w; odd
    # periodization axes (K1 and its VJP only: K2 rebuilds even images)
    "haar": [(2, 10, 6), (1, 70, 134), (1, 67, 33)],
    "db4": [(2, 12, 16), (1, 76, 142), (1, 45, 71)],
    # 102 taps on 37 samples wrap several periods; a tile of 8 or 16
    "coif17": [(1, 37, 37), (1, 38, 40), (1, 41, 52)],
}
CASES = [
    (inst, mode, wav, shape)
    for wav, shapes in SHAPES.items()
    for shape in shapes
    for inst, mode in INSTANCES
    if not (shape[1] % 2 or shape[2] % 2) or (mode == "periodization" and inst in ("K1", "K1 VJP"))
]


@pytest.mark.parametrize("item", [4, 8], ids=["f32plan", "f64plan"])
@pytest.mark.parametrize("instance,mode,wavelet,shape", CASES)
def test_tile_model_matches_operator_form(instance, mode, wavelet, shape, item):
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    n_taps = len(dl)
    lo, hi = (dl, dh) if instance in ("K1", "K1 VJP") else (rl, rh)
    entry, args = _launch_args(instance, mode, n_taps, *shape)
    got, want = _run_both(entry, args, lo, hi, n_taps, item, seed=sum(shape))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def _registry_lengths():
    return sorted({len(Wavelet(name).dec_lo) for name in wavelist(kind="discrete")})


def test_every_registry_length_has_a_tile():
    """Every bank of the registry (2 to 102 taps) in both dtypes, with and
    without the clamp, gets a tile of each kernel within the card's 227 KB."""
    lengths = _registry_lengths()
    assert lengths[0] == 2 and lengths[-1] == 102
    for n_taps in lengths:
        tp = (n_taps + 1) // 2
        for item in (4, 8):
            t = _pick(ANA_TILES, lambda t: ana_smem(t, tp, item))
            assert ana_smem(t, tp, item) <= SMEM_MAX
            for ext in (0, 1):
                t = _pick(SYN_TILES, lambda t: syn_smem(syn_shape(t, tp, ext, ext), item))
                assert syn_smem(syn_shape(t, tp, ext, ext), item) <= SMEM_MAX


@pytest.mark.parametrize(
    "n_taps,item,k1,k2",
    # the headline (db4 in float32) keeps the tiles of the source's table
    [(8, 4, 32, 64), (8, 8, 16, 32), (2, 4, 32, 64), (102, 4, 8, 16), (102, 8, 16, 32)],
)
def test_tile_table(n_taps, item, k1, k2):
    tp = (n_taps + 1) // 2
    assert _pick(ANA_TILES, lambda t: ana_smem(t, tp, item)) == k1
    assert _pick(SYN_TILES, lambda t: syn_smem(syn_shape(t, tp, 0, 0), item)) == k2


# ---------------------------------------------------------------------------
# through the port's glue against the JAX package
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


GLUE = [
    # (wavelet, shape, mode): below a tile, ragged, h != w, odd periodization
    ("haar", (2, 12, 10), "periodic"),
    ("haar", (1, 70, 36), "periodization"),
    ("db4", (2, 20, 36), "periodic"),
    ("db4", (1, 66, 140), "periodic"),
    ("db4", (1, 45, 71), "periodization"),
    ("coif17", (1, 110, 108), "periodic"),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("wavelet,shape,mode", GLUE)
def test_tile_glue_matches_jax(tile_kernels, wavelet, shape, mode, dtype):
    """K1 and K1's VJP, K2 and K2's VJP through the autograd Functions
    against ``analysis_nd``/``synthesis_nd`` and ``jax.vjp`` through them."""
    tol = 1e-10 if dtype == np.float64 else 2e-5
    dl, dh, rl, rh = _banks(wavelet, dtype)
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(dtype)
    assert t2d.fused2_analysis_applicable(shape[1], shape[2], len(dl), mode)

    want, vjp = jax.vjp(lambda z: j_analysis_nd(z, dl, dh, mode=mode, ndim=2), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = t2d.fused2_dwt_level(xt, dl, dh, mode)
    for g, w in zip(got, want):
        _close(g, w, tol)
    cts = [rng.randn(*g.shape).astype(dtype) for g in got]
    (grad,) = torch.autograd.grad(got, xt, [torch.from_numpy(c) for c in cts])
    _close(grad, vjp(tuple(jnp.asarray(c) for c in cts))[0], tol)
    assert tile_kernels["K1"] == 1 and tile_kernels["K2"] == 1

    if shape[1] % 2 or shape[2] % 2:
        return  # K2 rebuilds even images only
    p = 0 if mode == "periodization" else _std_pad(len(dl))
    bands = [np.array(w) for w in want]
    rec_want, rvjp = jax.vjp(
        lambda *bs: j_synthesis_nd(bs, jnp.asarray(rl), jnp.asarray(rh), pads=[(p, p)] * 2, mode=mode, ndim=2),
        *(jnp.asarray(bnd) for bnd in bands),
    )
    subbands = [torch.from_numpy(bnd).requires_grad_() for bnd in bands]
    assert t2d.fused2_synthesis_applicable(*bands[0].shape[-2:], len(rl), mode, [(p, p)] * 2)
    rec = t2d.fused2_idwt_level(subbands, rl, rh, mode)
    _close(rec, rec_want, tol)
    ct = rng.randn(*rec.shape).astype(dtype)
    grads = torch.autograd.grad(rec, subbands, torch.from_numpy(ct))
    for g, w in zip(grads, rvjp(jnp.asarray(ct))):
        _close(g, w, tol)
    assert tile_kernels["K1"] == 2 and tile_kernels["K2"] == 2


@pytest.mark.parametrize("mode", ["periodic", "periodization"])
@pytest.mark.parametrize("wavelet,shape", [("db4", (3, 16, 256)), ("haar", (2, 64, 256))])
def test_tile_glue_matches_jax_pallas(tile_kernels, wavelet, shape, mode):
    """On power-of-two shapes (the only ones the Pallas bodies unshuffle),
    against the JAX K1/K2 in interpret mode, float32."""
    dl, dh, rl, rh = _banks(wavelet)
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    want = j2d.fused2_dwt_level(jnp.asarray(x), dl, dh, mode)
    got = t2d.fused2_dwt_level(torch.from_numpy(x), dl, dh, mode)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    rec_want = j2d.fused2_idwt_level(want, rl, rh, mode)
    rec = t2d.fused2_idwt_level([torch.from_numpy(np.array(w)) for w in want], rl, rh, mode)
    _close(rec, rec_want, 2e-5)
    _close(rec, x, 2e-5)
    assert tile_kernels["K1"] == 1 and tile_kernels["K2"] == 1
