"""ptwt_tpu_torch.wavedec3/waverec3 against ptwt_tpu on the CPU.

The same numpy inputs go through both packages; on CPU tensors the port
runs the plain versions of K3/K4, routed axis by axis as the card routes
them.  The CUDA glue runs on the numpy kernel model (``model_kernels``)
with its launches counted.  Tolerances: float32 2e-5, float64 1e-12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.ops import _kernels
from _torch_one_thread import one_torch_thread  # noqa: F401

MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = {np.float32: 2e-5, np.float64: 1e-12}
KEYS = ["aad", "ada", "add", "daa", "dad", "dda", "ddd"]


def _flat(coeffs):
    return [coeffs[0]] + [d[k] for d in coeffs[1:] for k in KEYS]


def _assert_coeffs(got, want, tol):
    assert isinstance(got, tuple) and len(got) == len(want)
    for d in got[1:]:
        assert isinstance(d, dict) and list(d) == KEYS
    for g, w in zip(_flat(got), _flat(want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


def _rec_mode(mode):
    return mode if mode == "periodization" else None


def _round_trip(x, wavelet, mode, level, tol, axes=(-3, -2, -1)):
    want = jptwt.wavedec3(jnp.asarray(x), wavelet, mode=mode, level=level, axes=axes)
    got = tptwt.wavedec3(torch.from_numpy(x), wavelet, mode=mode, level=level, axes=axes)
    _assert_coeffs(got, want, tol)
    rec_want = np.asarray(jptwt.waverec3(want, wavelet, mode=_rec_mode(mode), axes=axes))
    rec = tptwt.waverec3(got, wavelet, mode=_rec_mode(mode), axes=axes)
    assert rec.dtype == got[0].dtype and tuple(rec.shape) == rec_want.shape
    np.testing.assert_allclose(rec.numpy(), rec_want, atol=tol, rtol=0)
    return rec


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape,wavelet,level",
    # odd and even axes; a leading batch of several dims and the default level
    [((2, 9, 10, 11), "db2", 2), ((2, 1, 8, 6, 8), "haar", None)],
)
def test_wavedec3_waverec3_match_jax(shape, wavelet, level, mode, dtype):
    x = np.random.RandomState(30).randn(*shape).astype(dtype)
    rec = _round_trip(x, wavelet, mode, level, TOL[dtype])
    np.testing.assert_allclose(
        rec.numpy()[..., : shape[-3], : shape[-2], : shape[-1]], x, atol=10 * TOL[dtype], rtol=0
    )


@pytest.mark.parametrize(
    "wavelet,shape,level",
    # the families, and coif17's 102 taps on axes a fraction of its length
    [("sym4", (1, 12, 9, 10), 1), ("bior2.2", (2, 10, 12, 14), 2), ("db3", (1, 7, 16, 5), None),
     ("coif17", (1, 5, 6, 7), 1)],
)
@pytest.mark.parametrize("mode", ["reflect", "periodization"])
def test_wavelet_families_match_jax(wavelet, shape, level, mode):
    x = np.random.RandomState(31).randn(*shape)
    _round_trip(x, wavelet, mode, level, 1e-12)


@pytest.mark.parametrize("mode", ["zero", "periodization"])
@pytest.mark.parametrize("axes", [(0, 2, 3), (1, -1, 0)])
def test_axes_argument_matches_jax(mode, axes):
    x = np.random.RandomState(32).randn(6, 2, 8, 10)
    rec = _round_trip(x, "db2", mode, 1, 1e-12, axes=axes)
    assert tuple(rec.shape) == x.shape


@pytest.mark.parametrize("shape,wavelet", [((16, 40, 33), "db2"), ((3, 64, 64, 70), "sym5"), ((5, 3, 100), "haar")])
def test_default_level_matches_jax(shape, wavelet):
    x = np.random.RandomState(33).randn(*shape)
    want = jptwt.wavedec3(jnp.asarray(x), wavelet)
    got = tptwt.wavedec3(torch.from_numpy(x), wavelet)
    filt_len = len(tptwt.RegistryWavelet(wavelet))
    assert len(got) == len(want) == 1 + min(tptwt.dwt_max_level(s, filt_len) for s in shape[-3:])
    _assert_coeffs(got, want, 1e-12)


@pytest.mark.parametrize("wavelet", ["haar", "db5", "coif17"])
def test_dwtn_max_level_matches_jax(wavelet):
    for shape in ((100, 100, 100), (16, 40, 33), (3, 1000), (512,)):
        assert tptwt.dwtn_max_level(shape, wavelet) == jptwt.dwtn_max_level(shape, wavelet)
    assert tptwt.dwtn_max_level((64, 64), tptwt.RegistryWavelet(wavelet)) == jptwt.dwtn_max_level((64, 64), wavelet)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
def test_empty_batch_matches_jax(mode, dtype):
    """``[0, 8, 8, 8]`` round-trips to an empty array of the input's shape."""
    x = np.zeros((0, 8, 8, 8), dtype=dtype)
    rec = _round_trip(x, "db2", mode, 2, TOL[dtype])
    assert tuple(rec.shape) == x.shape


def test_periodization_inferred():
    """A chain that halves on all three axes reconstructs circularly with no
    mode given; one that does not on one axis takes the padded crop."""
    for shape in ((1, 16, 32, 24), (1, 16, 32, 20)):
        x = np.random.RandomState(34).randn(*shape)
        want = jptwt.wavedec3(jnp.asarray(x), "db3", mode="periodization", level=2)
        got = tptwt.wavedec3(torch.from_numpy(x), "db3", mode="periodization", level=2)
        rec_want = np.asarray(jptwt.waverec3(want, "db3"))
        rec = tptwt.waverec3(got, "db3")
        assert tuple(rec.shape) == rec_want.shape
        np.testing.assert_allclose(rec.numpy(), rec_want, atol=1e-12, rtol=0)


def test_error_paths_match_jax():
    x = torch.ones(8, 8, 8, dtype=torch.float64)
    coeffs = tptwt.wavedec3(x, "haar", level=1)
    with pytest.raises(ValueError, match="7 arrays"):
        tptwt.waverec3((coeffs[0], {"aad": torch.ones(4, 4, 4)}), "haar")
    with pytest.raises(ValueError, match="7 arrays"):
        tptwt.waverec3((coeffs[0], list(coeffs[1].values())), "haar")
    bad = dict(coeffs[1])
    bad["aad"] = bad["aad"][..., :-1]
    with pytest.raises(ValueError, match="same shape"):
        tptwt.waverec3((coeffs[0], bad), "haar")
    bad = dict(coeffs[1])
    bad["xxx"] = bad.pop("ddd")
    with pytest.raises(KeyError):
        tptwt.waverec3((coeffs[0], bad), "haar")
    with pytest.raises(ValueError, match="same number of dimensions"):
        tptwt.waverec3((coeffs[0][None], coeffs[1]), "haar")
    with pytest.raises(ValueError, match="At least 3"):
        tptwt.wavedec3(torch.ones(8, 8), "haar")
    with pytest.raises(ValueError, match="twice"):
        tptwt.wavedec3(x, "haar", axes=(0, 0, 1))
    with pytest.raises(ValueError, match="3 axes"):
        tptwt.wavedec3(x, "haar", axes=(0, 1))
    with pytest.raises(ValueError, match="dtype"):
        tptwt.wavedec3(torch.ones(8, 8, 8, dtype=torch.float16), "haar")
    # ptwt_tpu raises the same types on the same inputs
    jx = jnp.ones((8, 8, 8))
    jc = jptwt.wavedec3(jx, "haar", level=1)
    with pytest.raises(ValueError, match="7 arrays"):
        jptwt.waverec3((jc[0], {"aad": jnp.ones((4, 4, 4))}), "haar")
    jbad = dict(jc[1])
    jbad["aad"] = jbad["aad"][..., :-1]
    with pytest.raises(ValueError, match="same shape"):
        jptwt.waverec3((jc[0], jbad), "haar")
    with pytest.raises(ValueError, match="At least 3"):
        jptwt.wavedec3(jnp.ones((8, 8)), "haar")


def test_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.wavedec3(np.zeros((8, 8, 8), dtype=np.float32), "haar")


@pytest.mark.parametrize(
    "shape,wavelet,mode,level",
    [((2, 9, 10, 11), "db2", "reflect", 2), ((1, 8, 12, 6), "db3", "periodization", 2),
     ((1, 7, 9, 6), "sym2", "periodic", 1)],
)
def test_cuda_glue_matches_jax(model_kernels, shape, wavelet, mode, level):  # noqa: F811
    """On the kernel path a level is three K3 launches and, back, four K4
    launches (two two-pair launches along -1, one along -2, one along -3)."""
    x = np.random.RandomState(35).randn(*shape)
    _round_trip(x, wavelet, mode, level, 1e-12)
    assert dict(model_kernels) == {**{k: 0 for k in model_kernels}, "K3": 3 * level, "K4": 4 * level}


def _loss(pkg, x, wavelet, mode, level, weights):
    coeffs = pkg.wavedec3(x, wavelet, mode=mode, level=level)
    rec = pkg.waverec3(coeffs, wavelet, mode=_rec_mode(mode))
    flat = _flat(coeffs) + [rec]
    return sum((c * w).sum() for c, w in zip(flat, weights))


@pytest.mark.parametrize("route", ["plain", "glue"])
@pytest.mark.parametrize("mode,shape", [("reflect", (1, 7, 8, 9)), ("periodization", (2, 8, 6, 10))])
def test_gradients_match_jax(request, route, mode, shape):
    """Gradients through ``wavedec3`` -> ``waverec3`` against ``jax.grad``;
    on the kernel path each K3 launch's VJP is one K4 launch and each K4
    launch's one K3 launch."""
    counts = request.getfixturevalue("model_kernels") if route == "glue" else None
    rng = np.random.RandomState(36)
    x = rng.randn(*shape)
    level = 2
    jc = jptwt.wavedec3(jnp.asarray(x), "db2", mode=mode, level=level)
    shapes = [c.shape for c in _flat(jc)] + [jptwt.waverec3(jc, "db2", mode=_rec_mode(mode)).shape]
    weights = [rng.randn(*s) for s in shapes]
    want = jax.grad(
        lambda z: _loss(jptwt, z, "db2", mode, level, [jnp.asarray(w) for w in weights])
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = _loss(tptwt, xt, "db2", mode, level, [torch.from_numpy(w) for w in weights])
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10, rtol=0)
    if counts is not None:
        assert {k: v for k, v in counts.items() if v} == {"K3": 4 * level, "K4": 3 * level}


def test_docstring_examples():
    import doctest
    import importlib

    mod = importlib.import_module("ptwt_tpu_torch.conv_transform_3")
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0
