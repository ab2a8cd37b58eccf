"""K5 of ptwt_tpu_torch (the 2d periodization pyramid) against the JAX package.

On the CPU the K5 wrappers run their plain versions (level by level
through ``dwt2_level_plain``/``idwt2_level_plain``); their CUDA glue runs on
the numpy model of ``tests/test_torch_kernels.py`` (``model_kernels``),
which executes ``csrc/pyramid2d.cu`` block by block: the tile cones, the
positions each block owns (every band position written once), the whole-
image case and the shared memory each launch asks for.  Both are held
against the JAX package's K5 kernels in Pallas interpret mode, called as
``tests/test_pallas.py`` calls them (float32, within 3e-6, that test's
tolerance), and the public ``wavedec2``/``waverec2`` in ``periodization``
against ``ptwt_tpu`` in float64 within 1e-10, gradients included.  The
kernels themselves meet their plain versions on the card in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _banks, model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu.ops import _pallas as j5
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t5
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL32 = 3e-6


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _flat(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


def _used(counts) -> set:
    return {k for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# the plain versions and the glue against the JAX package's K5 (interpret)
# ---------------------------------------------------------------------------


@pytest.fixture(params=["plain", "model"])
def route(request):
    """``plain``: CPU tensors take the plain versions; ``model``: they go
    down the CUDA glue onto the numpy model of the kernels."""
    if request.param == "plain":
        yield None
    else:
        yield request.getfixturevalue("model_kernels")


@pytest.mark.parametrize("wavelet", ["haar", "db4"])
@pytest.mark.parametrize("h,w,level", [(64, 256, 1), (64, 256, 2), (128, 128, 3)])
def test_k5_matches_jax_kernel(route, wavelet, h, w, level):
    dl, dh, rl, rh = _banks(wavelet)
    x = np.random.RandomState(3).randn(2, h, w).astype(np.float32)
    want = j5.fused_wavedec2d_per(jnp.asarray(x), dl, dh, level)
    got = t5.fused_wavedec2d_per(torch.from_numpy(x), dl, dh, level)
    assert len(got) == len(want) == level + 1
    for g, w_ in zip(_flat(got), jax.tree.leaves(tuple(want))):
        _close(g, w_, TOL32)
    bands = [torch.from_numpy(np.array(w_)) for w_ in jax.tree.leaves(tuple(want))]
    coeffs = [bands[0]] + [tuple(bands[1 + 3 * i : 4 + 3 * i]) for i in range(level)]
    rec = t5.fused_waverec2d_per(coeffs, rl, rh)
    _close(rec, j5.fused_waverec2d_per(want, rl, rh), TOL32)
    _close(rec, x, 2e-5)
    if route is not None:
        assert route["K5a"] == route["K5b"] == 1 and _used(route) == {"K5a", "K5b"}


def test_k5_band_order_is_subband_orders():
    """``lh`` is hi along H (rows) and ``hl`` hi along W, as the JAX kernel
    names them (``_pallas.py:264-266``): a signal that varies along W only
    has no energy in ``lh`` or ``hh``."""
    dl, dh, _, _ = _banks("db2")
    cols = np.random.RandomState(4).randn(64).astype(np.float32)
    x = np.broadcast_to(cols, (1, 32, 64)).copy()
    cA, (lh, hl, hh), _ = t5.fused_wavedec2d_per(torch.from_numpy(x), dl, dh, 2)
    jcA, (jlh, jhl, jhh), _ = j5.fused_wavedec2d_per(jnp.asarray(x), dl, dh, 2)
    assert float(lh.abs().max()) < 1e-5 and float(hh.abs().max()) < 1e-5
    assert float(hl.abs().max()) > 0.1
    for g, w_ in ((lh, jlh), (hl, jhl), (hh, jhh)):
        _close(g, w_, TOL32)


def test_k5_vjps_match_jax_kernel(model_kernels):  # noqa: F811
    """K5a's VJP (K5b) and K5b's VJP (K5a) against ``jax.grad`` through
    the JAX K5 pair, as ``tests/test_pallas.py`` checks it (float32)."""
    dl, dh, rl, rh = _banks("db2")
    x = np.random.RandomState(5).randn(1, 64, 256).astype(np.float32)

    def loss_jax(t):
        return sum(jnp.sum(jnp.sin(c)) for c in jax.tree.leaves(tuple(j5.fused_wavedec2d_per(t, dl, dh, 2))))

    xt = torch.from_numpy(x).requires_grad_()
    loss = sum(torch.sin(c).sum() for c in _flat(t5.fused_wavedec2d_per(xt, dl, dh, 2)))
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, jax.grad(loss_jax)(jnp.asarray(x)), 2e-5)
    assert _used(model_kernels) == {"K5b"}

    coeffs = j5.fused_wavedec2d_per(jnp.asarray(x), dl, dh, 2)
    packed = (coeffs[0], *(tuple(t) for t in coeffs[1:]))

    def rloss_jax(cs):
        return jnp.sum(jnp.sin(j5.fused_waverec2d_per(list(cs), rl, rh)))

    want = jax.tree.leaves(jax.grad(rloss_jax)(packed))
    leaves = [torch.from_numpy(np.array(c)).requires_grad_() for c in jax.tree.leaves(packed)]
    tcoeffs = [leaves[0], tuple(leaves[1:4]), tuple(leaves[4:7])]
    loss = torch.sin(t5.fused_waverec2d_per(tcoeffs, rl, rh)).sum()
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(loss, leaves)
    for g, w_ in zip(got, want):
        _close(g, w_, 2e-5)
    assert _used(model_kernels) == {"K5a"}


# ---------------------------------------------------------------------------
# the public path: wavedec2 / waverec2 in periodization, float64
# ---------------------------------------------------------------------------

# (shape, wavelet, level, runs of the plan or None where it declines)
PUBLIC = [
    ((2, 64, 64), "db4", 3, (3,)),  # the whole image in one launch
    ((1, 24, 20), "db2", 2, (2,)),  # not a power of two
    ((1, 128, 128), "db2", 4, (1, 3)),  # a tiled level, then the whole image
    ((1, 256, 160), "haar", 5, (1, 4)),  # ragged tiles along W, then the whole image
    ((1, 128, 128), "coif17", 2, None),  # 102 taps: declined, level by level
]


@pytest.mark.parametrize("shape,wavelet,level,runs", PUBLIC)
def test_public_path_matches_jax(model_kernels, shape, wavelet, level, runs):  # noqa: F811
    assert t5._pyramid2d_runs(*shape[1:], len(_banks(wavelet)[0]), level, 8) == runs
    x = np.random.RandomState(6).randn(*shape)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode="periodization", level=level)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode="periodization", level=level)
    for g, w_ in zip(_flat(got), _flat(want)):
        _close(g, w_, 1e-10)
    rec = tptwt.waverec2(got, wavelet, mode="periodization")
    _close(rec, jptwt.waverec2(want, wavelet, mode="periodization"), 1e-10)
    _close(rec, x, 1e-10)
    if runs is None:
        assert model_kernels["K1"] and model_kernels["K2"] and not model_kernels["K5a"]
    else:
        assert model_kernels["K5a"] == model_kernels["K5b"] == len(runs)
        assert _used(model_kernels) == {"K5a", "K5b"}


# (shape, level): an odd bank in periodization gives bands of period / 2 - 1
# (31 and 15 on 64 samples at 7 taps); K5's gate, and K1/K2's, decline it
ODD_BANK_2D = [((1, 64, 64), 2), ((2, 64, 48), 1)]


@pytest.mark.parametrize("shape,level", ODD_BANK_2D)
def test_odd_bank_takes_the_per_level_route(model_kernels, shape, level):  # noqa: F811
    rs = np.random.RandomState(72)
    bank = tuple(rs.randn(7) for _ in range(4))
    assert not t5.fused_wavedec2d_applicable(*shape[1:], 7, level, torch.float64)
    x = rs.randn(*shape)
    want = jptwt.wavedec2(jnp.asarray(x), bank, mode="periodization", level=level)
    got = tptwt.wavedec2(torch.from_numpy(x), bank, mode="periodization", level=level)
    for g, w_ in zip(_flat(got), _flat(want)):
        _close(g, w_, 1e-10)
    try:
        rec_want = np.asarray(jptwt.waverec2(want, bank, mode="periodization"))
    except AssertionError:
        # the reference refuses a multi-level chain of odd-bank bands
        with pytest.raises(AssertionError, match="padding error"):
            tptwt.waverec2(got, bank, mode="periodization")
        assert _used(model_kernels) == {"K3"}
        return
    _close(tptwt.waverec2(got, bank, mode="periodization"), rec_want, 1e-10)
    assert _used(model_kernels) == {"K3", "K4"}


def test_periodization_is_inferred_on_the_k5_route(model_kernels):  # noqa: F811
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 64, 64))
    coeffs = tptwt.wavedec2(x, "db3", mode="periodization", level=3)
    _close(tptwt.waverec2(coeffs, "db3"), x.numpy(), 1e-10)
    assert model_kernels["K5a"] == model_kernels["K5b"] == 1


def _public_loss(lib, x, wavelet, level, weights):
    """A loss that sends a different cotangent into every band and the
    reconstruction."""
    coeffs = lib.wavedec2(x, wavelet, mode="periodization", level=level)
    rec = lib.waverec2(coeffs, wavelet, mode="periodization")
    total = 0.5 * (rec**2).sum()
    for c, w_ in zip(_flat(coeffs), weights):
        total = total + (c * w_).sum() + 0.25 * (c**2).sum()
    return total


@pytest.mark.parametrize("shape,wavelet,level,runs", PUBLIC[:3])
def test_public_gradients_match_jax(model_kernels, shape, wavelet, level, runs):  # noqa: F811
    rng = np.random.RandomState(8)
    x = rng.randn(*shape)
    shapes = [c.shape for c in _flat(jptwt.wavedec2(jnp.asarray(x), wavelet, mode="periodization", level=level))]
    weights = [rng.randn(*s) for s in shapes]
    want = jax.grad(lambda z: _public_loss(jptwt, z, wavelet, level, [jnp.asarray(w_) for w_ in weights]))(
        jnp.asarray(x)
    )
    xt = torch.from_numpy(x).requires_grad_()
    loss = _public_loss(tptwt, xt, wavelet, level, [torch.from_numpy(w_) for w_ in weights])
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, want, 1e-10)
    # each launch's VJP is one launch of the other kernel
    assert model_kernels["K5a"] == model_kernels["K5b"] == len(runs)
    assert _used(model_kernels) == {"K5a", "K5b"}


def test_gradcheck_k5_path(model_kernels):  # noqa: F811
    x = torch.randn(1, 16, 16, dtype=torch.float64, generator=torch.Generator().manual_seed(9))

    def fn(inp):
        coeffs = tptwt.wavedec2(inp, "db2", mode="periodization", level=2)
        return (*_flat(coeffs), tptwt.waverec2(coeffs, "db2", mode="periodization"))

    assert torch.autograd.gradcheck(fn, (x.requires_grad_(),))
    assert model_kernels["K5a"] and model_kernels["K5b"]


def test_k5_refuses_filter_grad_and_double_backward(model_kernels, monkeypatch):  # noqa: F811
    """K5 refuses a filter gradient (by design); a second backward through
    its VJP (K5b, whose own VJP is K5a) meets the plain path's."""
    dl, dh, _, _ = _banks("db2", np.float64)
    x = torch.randn(1, 32, 32, dtype=torch.float64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t5.fused_wavedec2d_per(x, torch.tensor(dl, requires_grad=True), dh, 2)

    def grad_of_grad():
        xr = x.detach().requires_grad_()
        coeffs = t5.fused_wavedec2d_per(xr, dl, dh, 2)
        (grad,) = torch.autograd.grad(sum((c**3).sum() for c in _flat(coeffs)), xr, create_graph=True)
        return torch.autograd.grad((grad**2).sum(), xr)[0]

    _kernels.reset_launch_counts()
    got = grad_of_grad()
    assert model_kernels["K5a"] == 2 and model_kernels["K5b"] == 2
    with monkeypatch.context() as plain:
        plain.setattr(t5, "_on_cpu", lambda t: True)
        want = grad_of_grad()
    _close(got, want.numpy(), 1e-10 * float(want.abs().max()))


def test_plain_k5_carries_filter_gradients():
    """On the CPU the plain versions are autograd-transparent, filters too."""
    w = tptwt.RegistryWavelet("db2")
    bank = [torch.tensor(f, dtype=torch.float64, requires_grad=True) for f in w.filter_bank]
    x = torch.randn(1, 16, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(10))

    def loss(inp, *filters):
        coeffs = tptwt.wavedec2(inp, tuple(filters), mode="periodization", level=2)
        rec = tptwt.waverec2(coeffs, tuple(filters), mode="periodization")
        return (rec**2).sum() + sum((b**2).sum() for t in coeffs[1:] for b in t)

    assert torch.autograd.gradcheck(loss, (x.requires_grad_(), *bank))


def test_waverec2_mismatched_band_takes_the_per_level_path(model_kernels):  # noqa: F811
    coeffs = list(tptwt.wavedec2(torch.randn(2, 64, 64, dtype=torch.float64), "db2", mode="periodization", level=2))
    lh, hl, hh = coeffs[1]
    coeffs[1] = (lh[..., :-1], hl, hh)
    with pytest.raises(ValueError):
        tptwt.waverec2(coeffs, "db2", mode="periodization")
    assert model_kernels["K5b"] == 0


# ---------------------------------------------------------------------------
# the plan and the gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("filt_len", [2, 4, 8, 10, 20, 102])
@pytest.mark.parametrize("h,w,level", [(1024, 1024, 4), (128, 128, 3), (512, 256, 6), (96, 160, 5)])
def test_plan_is_held_by_the_card(itemsize, filt_len, h, w, level):
    """Every planned launch fits a block's shared memory; a tiled cone
    reads at most twice its tile's own input (except the depth-1 tiles of
    long filters on images that fit a block twice over); the runs cover
    the levels."""
    runs = t5._pyramid2d_runs(h, w, filt_len, level, itemsize)
    if runs is None:
        assert filt_len > 8 and 2 * h * w * itemsize > t5._SMEM_LIMIT
        return
    assert sum(runs) == level
    le = filt_len + (filt_len & 1)
    for depth in runs:
        for plan in (t5._analysis_plan, t5._synthesis_plan):
            ints, smem = plan(h, w, filt_len, depth, itemsize)
            assert len(ints) == 12 and smem <= t5._SMEM_LIMIT
        ints, _ = t5._analysis_plan(h, w, filt_len, depth, itemsize)
        th, tw, tiles_h, tiles_w, whole = ints[3:8]
        assert tiles_h * th >= h >> depth and tiles_w * tw >= w >> depth
        if not whole:
            cone = t5._cone_at(th, h, le, False, depth, 0) * t5._cone_at(tw, w, le, False, depth, 0)
            capped = cone <= t5._MAX_CONE_READ * (th << depth) * (tw << depth)
            assert capped or (depth == 1 and 2 * h * w * itemsize <= t5._SMEM_LIMIT)
        h, w = h >> depth, w >> depth


def test_gate():
    f32, f64 = torch.float32, torch.float64
    assert t5.fused_wavedec2d_applicable(1024, 1024, 8, 4, f32)
    # wide depth-1 tiles within the target: a depth-2 cone of db4 reads
    # more than twice its tile's input
    assert t5._pyramid2d_runs(1024, 1024, 8, 4, 4) == (1, 1, 1, 1)
    assert t5._pyramid2d_runs(1024, 1024, 8, 4, 8) == (1, 1, 1, 1)
    assert t5._analysis_plan(1024, 1024, 8, 1, 4)[0][3:5] == (4, 256)
    # db20: no tile within the target, the limit holds depth-1 runs
    assert t5._pyramid2d_runs(1024, 1024, 40, 4, 4) == (1, 1, 1, 1)
    # small images: the whole image, at any batch
    assert t5._pyramid2d_runs(128, 128, 8, 3, 4) == (3,)
    assert t5._plan_runs(128, 128, 8, 3, f32) == (3,)
    assert t5.fused_wavedec2d_applicable(24, 20, 4, 2, f64)
    assert not t5.fused_wavedec2d_applicable(24, 20, 4, 3, f64)  # 20 does not halve 3 times
    assert not t5.fused_wavedec2d_applicable(64, 64, 8, 0, f32)
    assert not t5.fused_wavedec2d_applicable(64, 64, 130, 2, f32)
    assert not t5.fused_wavedec2d_applicable(64, 64, 8, 2, torch.float16)
    # coif17 on a large image: no depth-1 tile reads under twice its input
    assert not t5.fused_wavedec2d_applicable(256, 256, 102, 2, f32)
    assert t5.fused_wavedec2d_applicable(64, 64, 102, 2, f32)  # whole image
