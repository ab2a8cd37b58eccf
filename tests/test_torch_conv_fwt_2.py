"""ptwt_tpu_torch.wavedec2/waverec2 against ptwt_tpu on the CPU.

The same numpy inputs go through both packages; on CPU tensors the port
runs the plain versions of its kernels, routed level by level as the
card routes them.  Tolerances: float32 2e-5, float64 1e-12.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.constants import WaveletDetailTuple2d
from ptwt_tpu_torch.utils import coeffs_from_numpy, coeffs_to_numpy
from _torch_one_thread import one_torch_thread  # noqa: F401

MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = {np.float32: 2e-5, np.float64: 1e-12}
DATA = Path(__file__).parent / "data"
_GOLDENS = np.load(DATA / "transform_goldens.npz")


def _flat(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


def _assert_coeffs(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


def _rec_mode(mode):
    # periodic passes its mode so the standard-crop levels take K2's route
    return mode if mode in ("periodic", "periodization") else None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape,wavelet,level",
    [((2, 31, 33), "db3", 2), ((1, 40, 48), "sym4", None), ((3, 16, 18), "haar", 3)],
)
def test_wavedec2_waverec2_match_jax(shape, wavelet, level, mode, dtype):
    x = np.random.RandomState(5).randn(*shape).astype(dtype)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode=mode, level=level)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode=mode, level=level)
    assert isinstance(got, tuple)
    assert all(isinstance(t, WaveletDetailTuple2d) for t in got[1:])
    _assert_coeffs(got, want, TOL[dtype])
    rec_want = jptwt.waverec2(want, wavelet, mode=_rec_mode(mode))
    rec = tptwt.waverec2(got, wavelet, mode=_rec_mode(mode))
    assert rec.dtype == got[0].dtype
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_want), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(
        rec.numpy()[..., : shape[-2], : shape[-1]], x, atol=10 * TOL[dtype], rtol=0
    )


@pytest.mark.parametrize("mode", ["reflect", "periodization"])
def test_axes_argument_matches_jax(mode):
    x = np.random.RandomState(6).randn(20, 22, 3)
    want = jptwt.wavedec2(jnp.asarray(x), "db2", mode=mode, level=2, axes=(0, 1))
    got = tptwt.wavedec2(torch.from_numpy(x), "db2", mode=mode, level=2, axes=(0, 1))
    _assert_coeffs(got, want, 1e-12)
    rec = tptwt.waverec2(got, "db2", axes=(0, 1), mode=_rec_mode(mode))
    want_rec = jptwt.waverec2(want, "db2", axes=(0, 1), mode=_rec_mode(mode))
    np.testing.assert_allclose(rec.numpy(), np.asarray(want_rec), atol=1e-12, rtol=0)


def test_reduced_headline_round_trip():
    """The headline's routing (db4, 4 levels, periodic) at a CPU size."""
    x = np.random.RandomState(9).randn(1, 258, 260).astype(np.float32)
    want = jptwt.wavedec2(jnp.asarray(x), "db4", mode="periodic", level=4)
    got = tptwt.wavedec2(torch.from_numpy(x), "db4", mode="periodic", level=4)
    _assert_coeffs(got, want, 2e-5)
    rec = tptwt.waverec2(got, "db4", mode="periodic")
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-4, rtol=0)


def _signal(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    return np.sin(0.37 * t) + 0.05 * t + np.cos(1.7 * t + 0.5)


def _image(h: int, w: int) -> np.ndarray:
    return np.outer(_signal(h), _signal(w)) + _signal(h * w).reshape(h, w)


@pytest.mark.parametrize(
    "key", sorted({k.rsplit("/", 1)[0] for k in _GOLDENS.files if k.startswith("wavedec2/")})
)
def test_wavedec2_goldens(key):
    _, name, mode = key.split("/")
    got = tptwt.wavedec2(torch.from_numpy(_image(24, 20)), name, mode=mode, level=2)
    flat = _flat(got)
    i = 0
    while f"{key}/{i}" in _GOLDENS:
        np.testing.assert_allclose(flat[i].numpy(), _GOLDENS[f"{key}/{i}"], atol=1e-9)
        i += 1
    assert i == len(flat)
    assert json.loads((DATA / "transform_goldens.json").read_text())["keys"]


@pytest.mark.parametrize("mode", ["periodic", "periodization", "symmetric"])
def test_cross_package_round_trips(mode):
    x = np.random.RandomState(10).randn(2, 36, 30)
    # JAX analysis -> port synthesis
    jcoeffs = jptwt.wavedec2(jnp.asarray(x), "db3", mode=mode, level=2)
    tcoeffs = coeffs_from_numpy(
        (np.asarray(jcoeffs[0]), *(tuple(np.asarray(b) for b in t) for t in jcoeffs[1:])),
        "cpu",
    )
    rec = tptwt.waverec2(tcoeffs, "db3", mode=_rec_mode(mode))
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-12, rtol=0)
    # port analysis -> JAX synthesis
    back = coeffs_to_numpy(tptwt.wavedec2(torch.from_numpy(x), "db3", mode=mode, level=2))
    jrec = jptwt.waverec2(
        (jnp.asarray(back[0]), *(tuple(jnp.asarray(b) for b in t) for t in back[1:])),
        "db3",
        mode=_rec_mode(mode),
    )
    np.testing.assert_allclose(np.asarray(jrec), x, atol=1e-12, rtol=0)


def test_periodization_inferred():
    x = torch.from_numpy(np.random.RandomState(11).randn(1, 64, 64))
    coeffs = tptwt.wavedec2(x, "db2", mode="periodization", level=3)
    assert [t[0].shape[-1] for t in coeffs[1:]] == [8, 16, 32]
    np.testing.assert_allclose(tptwt.waverec2(coeffs, "db2").numpy(), x.numpy(), atol=1e-12)


def _make_coeffs2(mode, n=64):
    x = torch.from_numpy(np.random.RandomState(11).randn(2, n, n).astype(np.float32))
    return tptwt.wavedec2(x, "db2", mode=mode, level=2)


@pytest.mark.parametrize("mode", ["periodization", "reflect"])
def test_waverec2_rejects_mismatched_band(mode):
    coeffs = list(_make_coeffs2(mode))
    lh, hl, hh = coeffs[1]
    coeffs[1] = (lh[..., :-1], hl, hh)  # one band one column short
    with pytest.raises(ValueError):
        tptwt.waverec2(coeffs, "db2", mode=mode)
    coeffs = list(_make_coeffs2(mode))
    lh, hl, hh = coeffs[1]
    coeffs[1] = (lh[..., :-1, :], hl, hh)  # one row short
    with pytest.raises(ValueError):
        tptwt.waverec2(coeffs, "db2", mode=mode)


@pytest.mark.parametrize("mode", ["periodization", "reflect"])
def test_waverec2_rejects_malformed_container(mode):
    coeffs = list(_make_coeffs2(mode))
    coeffs[1] = coeffs[1][0]  # array instead of 3-tuple
    with pytest.raises(ValueError):
        tptwt.waverec2(coeffs, "db2", mode=mode)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
def test_empty_batch_matches_jax(mode, dtype):
    """``[0, 32, 32]`` gives empty bands and round-trips to an empty array
    of the input's shape, as ``ptwt_tpu`` does."""
    x = np.zeros((0, 32, 32), dtype=dtype)
    want = jptwt.wavedec2(jnp.asarray(x), "db2", mode=mode, level=2)
    got = tptwt.wavedec2(torch.from_numpy(x), "db2", mode=mode, level=2)
    _assert_coeffs(got, want, TOL[dtype])
    rec_mode = mode if mode == "periodization" else None
    rec_want = np.asarray(jptwt.waverec2(want, "db2", mode=rec_mode))
    rec = tptwt.waverec2(got, "db2", mode=rec_mode)
    assert tuple(rec.shape) == rec_want.shape == x.shape


@pytest.mark.parametrize("mode", ["periodization", "periodic", "reflect"])
def test_empty_batch_on_the_kernel_glue(model_kernels, mode):  # noqa: F811
    """The CUDA glue (on the numpy kernel model) takes an empty batch on the
    K5 pyramid, K1/K2 and K3/K4 routes and launches nothing."""
    x = np.zeros((0, 32, 32))
    got = tptwt.wavedec2(torch.from_numpy(x), "db2", mode=mode, level=2)
    _assert_coeffs(got, jptwt.wavedec2(jnp.asarray(x), "db2", mode=mode, level=2), 1e-12)
    assert tuple(tptwt.waverec2(got, "db2", mode=mode).shape) == x.shape
    assert not any(model_kernels.values())


def _odd_bank_of(taps: int):
    rs = np.random.RandomState(74)
    return tuple(rs.randn(taps) for _ in range(4))


@pytest.mark.parametrize("route", ["plain", "glue"])
def test_odd_bank_empty_chain_matches_jax(request, route):
    """An odd-length bank's periodization chain whose bands run empty:
    ``wavedec2`` raises ``ValueError`` where ``ptwt_tpu`` does (``[1, 52,
    6]``, 3 taps, level 4: the last level's input has no columns), and
    ``waverec2`` of ``[1, 1, 54]``'s bands (9 taps, level 1) gives ``[1, 0,
    52]``, as ``ptwt_tpu`` does."""
    if route == "glue":
        request.getfixturevalue("model_kernels")
    x = np.random.RandomState(75).randn(1, 52, 6)
    bank = _odd_bank_of(3)
    with pytest.raises(ValueError):
        jptwt.wavedec2(jnp.asarray(x), bank, mode="periodization", level=4)
    with pytest.raises(ValueError, match="negative dimensions"):
        tptwt.wavedec2(torch.from_numpy(x), bank, mode="periodization", level=4)
    x = np.random.RandomState(76).randn(1, 1, 54)
    bank = _odd_bank_of(9)
    want = jptwt.wavedec2(jnp.asarray(x), bank, mode="periodization", level=1)
    got = tptwt.wavedec2(torch.from_numpy(x), bank, mode="periodization", level=1)
    _assert_coeffs(got, want, 1e-10)
    rec_want = np.asarray(jptwt.waverec2(want, bank, mode="periodization"))
    rec = tptwt.waverec2(got, bank, mode="periodization")
    assert tuple(rec.shape) == rec_want.shape == (1, 0, 52)


def test_wavedec2_rejects_bad_axes():
    x = torch.zeros(4, 8, 8)
    with pytest.raises(ValueError):
        tptwt.wavedec2(x, "haar", axes=(1, 1))
    with pytest.raises(ValueError):
        tptwt.wavedec2(x, "haar", axes=(0,))
    with pytest.raises(ValueError):
        tptwt.wavedec2(torch.zeros(8), "haar")


@pytest.mark.parametrize("module", ["conv_transform_2", "wavelets"])
def test_docstring_examples(module):
    import doctest
    import importlib

    mod = importlib.import_module(f"ptwt_tpu_torch.{module}")
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("mode", ["periodization", "periodic"])
@pytest.mark.parametrize("wavelet", ["coif17", "dmey"])
def test_long_filters_on_short_axes_match_jax(wavelet, mode):
    """Filters far longer than the axis: the boundary maps wrap several
    times and the periodization fold overhangs its output."""
    x = np.random.RandomState(12).randn(1, 37, 40)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode=mode, level=2)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode=mode, level=2)
    _assert_coeffs(got, want, 1e-12)
    rec = tptwt.waverec2(got, wavelet, mode=mode)
    np.testing.assert_allclose(
        rec.numpy(), np.asarray(jptwt.waverec2(want, wavelet, mode=mode)), atol=1e-12, rtol=0
    )
    np.testing.assert_allclose(rec.numpy()[..., :37, :40], x, atol=1e-10, rtol=0)
