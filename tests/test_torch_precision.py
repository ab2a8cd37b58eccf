"""The reduced-precision mode against ``ptwt_tpu`` on the CPU.

Under ``set_precision("high")`` / ``("default")`` (the JAX package's
``Precision.HIGH`` / ``Precision.DEFAULT``) a float32 level takes the
dense-operator route on every axis of at most ``get_matmul_max_length()``
samples, as the JAX package's does.  On the CPU every level computes
exactly (so do JAX's), so the transforms and their gradients are held
against JAX within float64 1e-10 and float32 1e-5, and the route is read
from the launch counts of the CUDA glue on the numpy kernel model
(``model_kernels``): no K1/K2/K3/K4 below the cutoff, the kernels of
``"highest"`` above it and on banks that require grad.

Both packages' precision knobs are module globals, and other files run in
the same worker, so the ``precision`` fixture sets both and restores both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu.ops as jops
import ptwt_tpu_torch as tptwt
import ptwt_tpu_torch.ops as tops
from ptwt_tpu_torch.ops import _kernels
from _torch_one_thread import one_torch_thread  # noqa: F401

MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = {np.float32: 1e-5, np.float64: 1e-10}
LEVELS = {"high": jax.lax.Precision.HIGH, "default": jax.lax.Precision.DEFAULT}


@pytest.fixture(params=["default", "high"])
def precision(request):
    """Both packages at one reduced level; both back at their default
    (``"highest"``) afterwards, whatever the test did."""
    try:
        jops.set_precision(LEVELS[request.param])
        tops.set_precision(request.param)
        yield request.param
    finally:
        jops.set_precision(jax.lax.Precision.HIGHEST)
        tops.set_precision("highest")


@pytest.fixture
def default_precision():
    try:
        jops.set_precision(jax.lax.Precision.DEFAULT)
        tops.set_precision("default")
        yield
    finally:
        jops.set_precision(jax.lax.Precision.HIGHEST)
        tops.set_precision("highest")


def _leaves(coeffs):
    out = [coeffs[0]]
    for item in coeffs[1:]:
        if isinstance(item, dict):
            out += [item[k] for k in sorted(item)]
        elif isinstance(item, (tuple, list)):
            out += list(item)
        else:
            out.append(item)
    return out


def _close(got, want, tol):
    for g, w in zip(_leaves(got) if isinstance(got, (tuple, list)) else [got],
                    _leaves(want) if isinstance(want, (tuple, list)) else [want]):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.detach().numpy(), w, atol=TOL[w.dtype.type], rtol=0)


def _rec_mode(mode):
    return mode if mode in ("periodic", "periodization") else None


SHAPES = {1: (2, 37), 2: (2, 21, 16), 3: (1, 9, 10, 11)}
FUNCS = {1: ("wavedec", "waverec"), 2: ("wavedec2", "waverec2"), 3: ("wavedec3", "waverec3")}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_transforms_match_jax(precision, dim, mode, dtype):
    x = np.random.RandomState(dim).randn(*SHAPES[dim]).astype(dtype)
    dec, rec = FUNCS[dim]
    wavelet = "db3" if dim < 3 else "db2"
    want = getattr(jptwt, dec)(jnp.asarray(x), wavelet, mode=mode, level=2)
    got = getattr(tptwt, dec)(torch.from_numpy(x), wavelet, mode=mode, level=2)
    _close(got, want, TOL[dtype])
    rec_mode = _rec_mode(mode) if dim < 3 else (mode if mode == "periodization" else None)
    _close(getattr(tptwt, rec)(got, wavelet, mode=rec_mode), getattr(jptwt, rec)(want, wavelet, mode=rec_mode),
           TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_separable_and_packets_match_jax(default_precision, dtype):
    x = np.random.RandomState(7).randn(2, 19, 24).astype(dtype)
    want = jptwt.fswavedec2(jnp.asarray(x), "db2", mode="reflect", level=2)
    got = tptwt.fswavedec2(torch.from_numpy(x), "db2", mode="reflect", level=2)
    _close(got, want, TOL[dtype])
    _close(tptwt.fswaverec2(got, "db2"), jptwt.fswaverec2(want, "db2"), TOL[dtype])
    tp = tptwt.WaveletPacket2D(torch.from_numpy(x), "db3", mode="reflect", maxlevel=2)
    jp = jptwt.WaveletPacket2D(jnp.asarray(x), "db3", mode="reflect", maxlevel=2)
    order = tp.get_level(2, "natural")
    tp.initialize(order)
    jp.initialize(order)
    assert set(tp.data) == set(jp.data)
    for key in jp.data:
        _close(tp.data[key], jp.data[key], TOL[dtype])
    tp.reconstruct()
    jp.reconstruct()
    _close(tp[""], jp[""], TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", ["reflect", "periodic", "periodization"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_gradients_match_jax_grad(model_kernels, default_precision, dim, mode, dtype):  # noqa: F811
    """The gradient of a weighted round trip against ``jax.grad`` of the
    same loss: in float32 through the dense route's backward (the
    transposed operators; no K1-K4 launch on the CUDA glue, forward or
    backward; the 2d periodization pyramid, K5, keeps its route),
    within 1e-4 of the largest entry; in float64 through the exact
    kernels' backward, within 1e-10."""
    rng = np.random.RandomState(10 + dim)
    x = rng.randn(*SHAPES[dim]).astype(dtype)
    dec, rec = FUNCS[dim]
    wavelet = "db3" if dim < 3 else "db2"
    rec_mode = mode if mode == "periodization" or (dim < 3 and mode == "periodic") else None
    shapes = [np.shape(c) for c in _leaves(getattr(jptwt, dec)(jnp.asarray(x), wavelet, mode=mode, level=2))]
    weights = [rng.randn(*s).astype(dtype) for s in shapes]

    def loss(pkg, xx, ws):
        coeffs = getattr(pkg, dec)(xx, wavelet, mode=mode, level=2)
        out = sum((c * w).sum() for c, w in zip(_leaves(coeffs), ws))
        return out + (getattr(pkg, rec)(coeffs, wavelet, mode=rec_mode) ** 2).sum()

    want = np.asarray(jax.grad(lambda xx: loss(jptwt, xx, [jnp.asarray(w) for w in weights]))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss(tptwt, xt, [torch.from_numpy(w) for w in weights]), xt)
    launched = {k for k, v in _kernels.LAUNCHES.items() if v}
    assert got.dtype == xt.dtype
    if dtype == np.float64:
        assert launched & {"K1", "K3", "K5a"}
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
        return
    assert launched <= ({"K5a", "K5b"} if dim == 2 and mode == "periodization" else set())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * float(np.abs(want).max()), rtol=0)


def _counts(fn):
    _kernels.reset_launch_counts()
    fn()
    return {k: v for k, v in _kernels.LAUNCHES.items() if v}


def test_glue_launches_no_kernel_below_the_cutoff(model_kernels, precision):  # noqa: F811
    """Below the cutoff the CUDA glue launches nothing: every level of the
    2d (periodic, where ``"highest"`` runs K1/K2), 3d and 1d round trips is
    a dense product."""
    x2 = torch.from_numpy(np.random.RandomState(3).randn(1, 66, 70).astype(np.float32))
    x3 = torch.from_numpy(np.random.RandomState(4).randn(1, 12, 10, 14).astype(np.float32))
    x1 = torch.from_numpy(np.random.RandomState(5).randn(2, 300).astype(np.float32))
    runs = [
        lambda: tptwt.waverec2(tptwt.wavedec2(x2, "db3", mode="periodic", level=2), "db3", mode="periodic"),
        lambda: tptwt.waverec3(tptwt.wavedec3(x3, "db2", mode="reflect", level=2), "db2"),
        lambda: tptwt.waverec(tptwt.wavedec(x1, "db4", mode="symmetric", level=3), "db4"),
    ]
    for run in runs:
        assert _counts(run) == {}
    tops.set_precision("highest")
    assert {"K1", "K2"} <= set(_counts(runs[0]))


def test_glue_launches_the_kernels_above_the_cutoff(model_kernels, precision):  # noqa: F811
    """With the cutoff at 40 samples, level 1 of a 66 x 70 reflect image
    launches what ``"highest"`` launches for it (K3 twice, K4 twice) and
    level 2 (axes of 35 and 37 samples) nothing; a periodic one declines
    K1/K2 there for K3/K4, as the JAX package's K1 gate does."""
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 66, 70).astype(np.float32))

    def round_trip(mode, level):
        rec_mode = _rec_mode(mode)
        return lambda: tptwt.waverec2(tptwt.wavedec2(x, "db3", mode=mode, level=level), "db3", mode=rec_mode)

    tops.set_matmul_max_length(40)
    try:
        reduced = _counts(round_trip("reflect", 2))
        assert reduced == {"K3": 2, "K4": 2}
        assert _counts(round_trip("periodic", 2)) == {"K3": 2, "K4": 2}
        level = tops.get_precision()
        tops.set_precision("highest")
        assert _counts(round_trip("reflect", 1)) == reduced
        assert set(_counts(round_trip("periodic", 2))) == {"K1", "K2", "K3", "K4"}
        tops.set_precision(level)
    finally:
        tops.set_matmul_max_length(2048)
    assert tops.get_matmul_max_length() == 2048


def test_cutoff_moves_the_route(model_kernels, default_precision):  # noqa: F811
    """``set_matmul_max_length`` moves the cutoff both ways: the same 1d
    level is dense at 300 samples and runs K3/K4 below that."""
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 300).astype(np.float32))

    def run():
        return tptwt.waverec(tptwt.wavedec(x, "db4", mode="reflect", level=1), "db4")

    for cutoff, want in ((300, {}), (299, {"K3": 1, "K4": 1}), (2048, {})):
        tops.set_matmul_max_length(cutoff)
        try:
            assert _counts(run) == want
        finally:
            tops.set_matmul_max_length(2048)


def test_glue_keeps_the_kernels_for_a_bank_that_requires_grad(model_kernels, precision):  # noqa: F811
    """A bank that requires grad keeps K3/K4 and gets its gradient from KT,
    under every precision."""
    from ptwt_tpu_torch.utils import get_filter_arrays

    bank = [torch.tensor(np.asarray(f), dtype=torch.float32, requires_grad=True)
            for f in get_filter_arrays("db2", flip=False, dtype=torch.float64)]
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 20, 18).astype(np.float32))
    _kernels.reset_launch_counts()
    rec = tptwt.waverec2(tptwt.wavedec2(x, tuple(bank), mode="reflect", level=2), tuple(bank))
    torch.autograd.grad(rec.square().sum(), bank)
    launched = {k for k, v in _kernels.LAUNCHES.items() if v}
    assert launched == {"K3", "K4", "KT"}


def test_glue_declines_the_k9_opt_in(model_kernels, precision, monkeypatch):  # noqa: F811
    """With ``PTWT_TPU_MXU2D=1``, a float32 level K9 takes at
    ``"highest"`` is a dense product under a reduced precision."""
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    x = torch.from_numpy(np.random.RandomState(11).randn(1, 128, 256).astype(np.float32))

    def run():
        return tptwt.waverec2(tptwt.wavedec2(x, "db2", mode="periodic", level=1), "db2", mode="periodic")

    assert _counts(run) == {}
    tops.set_precision("highest")
    assert _counts(run) == {"K9a": 1, "K9b": 1}


def test_callers_settings_are_restored(precision):
    """A transform under a reduced precision leaves torch's global matmul
    and cuDNN TF32 settings as the caller set them."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 16, 16).astype(np.float32))
    filt = tptwt.utils.construct_nd_filter(np.ones(2, np.float32), np.ones(2, np.float32), 2)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = False
        tptwt.waverec2(tptwt.wavedec2(x, "db2", mode="reflect", level=2), "db2")
        tops.synthesis_conv(tops.analysis_conv(x, filt), filt)
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert tops.get_precision() == precision


def test_precision_levels_by_name():
    assert tops.get_precision() == "highest"
    for level in ("high", "medium", "default", "highest"):
        tops.set_precision(level)
        assert tops.get_precision() == level
    with pytest.raises(ValueError, match="precision"):
        tops.set_precision("bfloat16")
    assert tops.get_precision() == "highest"


@pytest.mark.parametrize("level", ["default", "high"])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_padded_product_layout(monkeypatch, level, transposed, axis):
    """The card's reduced-precision product (``_padded_product``) on the CPU,
    with ``torch.mm``/``torch.bmm`` standing in for cuBLAS (float32
    products of the padded operands): odd lengths padded to 8 with zeros,
    the operator or its transpose, every axis, a batch of two dims; the
    result against the float64 product of the same (rounded) operands."""
    from ptwt_tpu_torch.ops import _conv

    mm, bmm = torch.mm, torch.bmm
    monkeypatch.setattr(torch, "mm", lambda a, b, out_dtype=None: mm(a.float(), b.float()))
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: bmm(a.float(), b.float()))
    monkeypatch.setattr(_conv, "_PRECISION", level)
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 3, 13, 11, 7).astype(np.float32))
    n = x.shape[axis]
    matrix = torch.from_numpy(rng.randn(*((n, 2 * n + 1) if transposed else (2 * n + 1, n))).astype(np.float32))
    dtype = torch.bfloat16 if level == "default" else torch.float32
    aligned = _conv.aligned_operator(matrix, dtype)
    assert aligned.dtype == dtype and all(s % 8 == 0 for s in aligned.shape)
    assert not aligned[matrix.shape[0]:].any() and not aligned[:, matrix.shape[1]:].any()
    got = _conv._padded_product(x, aligned, tuple(matrix.shape), axis, transposed)
    op = (matrix.to(dtype).double().mT if transposed else matrix.to(dtype).double())
    want = torch.movedim(torch.movedim(x.to(dtype).double(), axis, -1) @ op.mT, -1, axis)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert torch.get_float32_matmul_precision() == "highest"


def test_dense_route_caches_only_aligned_operators(monkeypatch, default_precision):
    """The dense route as on the card (``_level`` of a CPU tensor as of a
    card's, ``torch.mm``/``torch.bmm`` as above): the byte-capped device
    cache holds each operator once, as its aligned bfloat16 copy, counted
    whole; the round trip is within bfloat16's reach of float64 and its
    backward reuses the cached copies."""
    from ptwt_tpu_torch.ops import _conv, _matmul

    mm, bmm = torch.mm, torch.bmm
    monkeypatch.setattr(torch, "mm", lambda a, b, out_dtype=None: mm(a.float(), b.float()))
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: bmm(a.float(), b.float()))
    monkeypatch.setattr(_conv, "_level", lambda x: _conv._PRECISION if x.dtype == torch.float32 else "highest")
    _matmul._DEVICE.clear()
    x64 = torch.from_numpy(np.random.RandomState(14).randn(2, 21, 19))
    x = x64.float().requires_grad_()
    rec = tptwt.waverec2(tptwt.wavedec2(x, "db3", mode="reflect", level=2), "db3")
    entries = dict(_matmul._DEVICE._store)
    assert entries and all(key[1] == torch.bfloat16 and key[3] == "aligned" for key in entries)
    for key, aligned in entries.items():
        rows, cols = _matmul._host(key[0]).shape
        assert aligned.shape == (-(-rows // 8) * 8, -(-cols // 8) * 8)
    torch.autograd.grad(rec.square().sum(), x)
    assert dict(_matmul._DEVICE._store).keys() == entries.keys()
    want = tptwt.waverec2(tptwt.wavedec2(x64, "db3", mode="reflect", level=2), "db3")
    assert float((rec.detach().double() - want).abs().max()) <= 3e-2 * float(want.abs().max())
    _matmul._DEVICE.clear()
