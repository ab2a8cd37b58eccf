"""ptwt_tpu_torch.fswavedec2/3 and fswaverec2/3 against ptwt_tpu on the CPU.

The same numpy inputs go through both packages; on CPU tensors the port
runs the plain versions of K3/K4, one call of the per-axis route per axis
pass on every sibling band at once.  The CUDA glue runs on the numpy
kernel model (``model_kernels``) with its launches counted.  Tolerances:
float32 2e-5, float64 1e-12.
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
KEYS = {2: ["ad", "da", "dd"], 3: ["aad", "ada", "add", "daa", "dad", "dda", "ddd"]}
FUNCS = {2: ("fswavedec2", "fswaverec2"), 3: ("fswavedec3", "fswaverec3")}


def _flat(coeffs, ndim):
    return [coeffs[0]] + [d[k] for d in coeffs[1:] for k in KEYS[ndim]]


def _assert_coeffs(got, want, ndim, tol):
    assert isinstance(got, tuple) and len(got) == len(want)
    for d in got[1:]:
        assert isinstance(d, dict) and list(d) == KEYS[ndim]
    for g, w in zip(_flat(got, ndim), _flat(want, ndim)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


def _dec(x, wavelet, mode, level, ndim, tol, axes=None):
    fwd, _ = FUNCS[ndim]
    want = getattr(jptwt, fwd)(jnp.asarray(x), wavelet, mode=mode, level=level, axes=axes)
    got = getattr(tptwt, fwd)(torch.from_numpy(x), wavelet, mode=mode, level=level, axes=axes)
    _assert_coeffs(got, want, ndim, tol)
    return got, want


def _round_trip(x, wavelet, mode, level, ndim, tol, axes=None):
    """Both packages' coefficients and reconstructions agree, or both
    reconstructions raise ``ValueError`` (a multi-level periodization
    chain: the synthesis is the padded one)."""
    got, want = _dec(x, wavelet, mode, level, ndim, tol, axes)
    _, inv = FUNCS[ndim]
    try:
        rec_want = np.asarray(getattr(jptwt, inv)(want, wavelet, axes=axes))
    except ValueError:
        with pytest.raises(ValueError, match="same shape"):
            getattr(tptwt, inv)(got, wavelet, axes=axes)
        return None
    rec = getattr(tptwt, inv)(got, wavelet, axes=axes)
    assert rec.dtype == got[0].dtype and tuple(rec.shape) == rec_want.shape
    np.testing.assert_allclose(rec.numpy(), rec_want, atol=tol, rtol=0)
    return rec


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape,wavelet,level",
    # odd and even axes; a leading batch of several dims and the default level
    [((2, 17, 20), "db2", 2), ((2, 1, 32, 24), "haar", None)],
)
def test_fswavedec2_fswaverec2_match_jax(shape, wavelet, level, mode, dtype):
    x = np.random.RandomState(40).randn(*shape).astype(dtype)
    rec = _round_trip(x, wavelet, mode, level, 2, TOL[dtype])
    if mode != "periodization":
        np.testing.assert_allclose(
            rec.numpy()[..., : shape[-2], : shape[-1]], x, atol=10 * TOL[dtype], rtol=0
        )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
def test_fswavedec3_fswaverec3_match_jax(mode, dtype):
    shape = (2, 9, 10, 11)
    x = np.random.RandomState(41).randn(*shape).astype(dtype)
    rec = _round_trip(x, "sym2", mode, 2, 3, TOL[dtype])
    if mode != "periodization":
        np.testing.assert_allclose(rec.numpy()[..., :9, :10, :11], x, atol=10 * TOL[dtype], rtol=0)


@pytest.mark.parametrize(
    "wavelet,shape,level",
    # the families, and coif17's 102 taps on axes a fraction of its length
    [("sym4", (1, 12, 19), 2), ("bior2.2", (2, 14, 12), 2), ("db3", (1, 7, 16), 1), ("coif17", (1, 9, 12), 1)],
)
@pytest.mark.parametrize("mode", ["reflect", "periodization"])
def test_wavelet_families_match_jax(wavelet, shape, level, mode):
    x = np.random.RandomState(42).randn(*shape)
    _round_trip(x, wavelet, mode, level, 2, 1e-12)


@pytest.mark.parametrize("ndim,axes", [(2, (0, 2)), (2, (-1, 1)), (3, (2, 0, 1))])
def test_axes_argument_matches_jax(ndim, axes):
    x = np.random.RandomState(43).randn(8, 4, 10, 6)
    rec = _round_trip(x, "db2", "zero", 1, ndim, 1e-12, axes=axes)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10, rtol=0)


@pytest.mark.parametrize(
    "shape,wavelet,ndim",
    # int(min(log2(n / (L - 1)))): 3 and 4 levels, and none (log2 < 0)
    [((40, 70), "db2", 2), ((1, 33, 64, 40), "haar", 3), ((2, 3, 3), "db4", 2)],
)
def test_default_level_matches_jax(shape, wavelet, ndim):
    x = np.random.RandomState(44).randn(*shape)
    got, want = _dec(x, wavelet, "reflect", None, ndim, 1e-12)
    filt_len = len(tptwt.RegistryWavelet(wavelet))
    level = int(min(np.log2(n / (filt_len - 1)) for n in shape[-ndim:]))
    assert len(got) == 1 + max(level, 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
def test_empty_batch_matches_jax(mode, dtype):
    """``[0, 16, 16]`` gives empty bands and reconstructs to an empty array
    of the input's shape (one level: the periodization synthesis of a
    single level is the padded one, shorter by ``L - 2``)."""
    x = np.zeros((0, 16, 16), dtype=dtype)
    rec = _round_trip(x, "db2", mode, 1, 2, TOL[dtype])
    assert rec.shape[0] == 0
    if mode != "periodization":
        assert tuple(rec.shape) == x.shape
    if dtype == np.float64:
        rec3 = _round_trip(np.zeros((0, 8, 8, 8), dtype=dtype), "haar", mode, 2, 3, TOL[dtype])
        assert tuple(rec3.shape) == (0, 8, 8, 8)


def test_periodization_facts_match_jax():
    """``fswaverec*`` take no mode: one periodization level comes back
    ``L - 2`` samples short per axis, and two levels raise ``ValueError``
    (the crop of the approximation cannot grow it), as in ``ptwt_tpu``;
    ``reflect`` and ``periodic`` round-trip."""
    x = np.random.RandomState(45).randn(2, 16, 16)
    rec = _round_trip(x, "db2", "periodization", 1, 2, 1e-12)
    assert tuple(rec.shape) == (2, 14, 14)
    with pytest.raises(ValueError, match="same shape"):
        jptwt.fswaverec2(jptwt.fswavedec2(jnp.asarray(x), "db2", mode="periodization", level=2), "db2")
    coeffs = tptwt.fswavedec2(torch.from_numpy(x), "db2", mode="periodization", level=2)
    with pytest.raises(ValueError, match="coefficients on each level must have the same shape"):
        tptwt.fswaverec2(coeffs, "db2")
    for mode in ("reflect", "periodic"):
        rec = tptwt.fswaverec2(tptwt.fswavedec2(torch.from_numpy(x), "db2", mode=mode, level=2), "db2")
        np.testing.assert_allclose(rec.numpy(), x, atol=1e-13, rtol=0)


def test_error_paths_match_jax():
    with pytest.raises(ValueError, match="approximation"):
        tptwt.fswaverec2(({"ad": torch.ones(4, 4)},), "haar")
    coeffs = tptwt.fswavedec2(torch.ones(8, 8, dtype=torch.float64), "haar", level=1)
    with pytest.raises(ValueError, match="dicts"):
        tptwt.fswaverec2((coeffs[0], torch.ones(4, 4)), "haar")
    with pytest.raises(ValueError, match="At least 2"):
        tptwt.fswavedec2(torch.ones(8), "haar")
    with pytest.raises(ValueError, match="3 axes"):
        tptwt.fswavedec3(torch.ones(8, 8, 8), "haar", axes=(0, 1))
    with pytest.raises(ValueError, match="dtype"):
        tptwt.fswavedec2(torch.ones(8, 8, dtype=torch.float16), "haar")
    # malformed level dicts fail where ptwt_tpu's fail, with its types
    x = np.random.RandomState(46).randn(2, 16, 16)
    got = tptwt.fswavedec2(torch.from_numpy(x), "db2", level=2)
    want = jptwt.fswavedec2(jnp.asarray(x), "db2", level=2)
    cases = [
        ("dd", (Ellipsis, slice(None, -1)), TypeError),  # off the first pass's axis
        ("da", (Ellipsis, slice(None, -1)), ValueError),  # on its axis
        ("ad", (Ellipsis, slice(None, -1), slice(None)), ValueError),
    ]
    for key, index, error in cases:
        for pkg, coeffs in ((jptwt, want), (tptwt, got)):
            bad = dict(coeffs[1])
            bad[key] = bad[key][index]
            with pytest.raises(error):
                pkg.fswaverec2((coeffs[0], bad, coeffs[2]), "db2")
    for pkg, coeffs in ((jptwt, want), (tptwt, got)):
        bad = dict(coeffs[1])
        del bad["dd"]
        with pytest.raises(KeyError):
            pkg.fswaverec2((coeffs[0], bad, coeffs[2]), "db2")


def test_matches_the_2d_transform_for_orthogonal_wavelets():
    """One separable level equals one ``wavedec2`` level (H = da, V = ad,
    D = dd), as ``tests/test_separable_fwt.py`` checks for ``ptwt_tpu``."""
    x = torch.from_numpy(np.random.RandomState(47).randn(32, 32))
    approx, details = tptwt.fswavedec2(x, "db2", level=1, mode="zero")
    a2, (h, v, d) = tptwt.wavedec2(x, "db2", level=1, mode="zero")
    for got, want in ((approx, a2), (details["da"], h), (details["ad"], v), (details["dd"], d)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=0)


def test_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.fswavedec2(np.zeros((8, 8), dtype=np.float32), "haar")


@pytest.mark.parametrize(
    "ndim,shape,wavelet,mode,level",
    [(2, (2, 17, 20), "db2", "reflect", 2), (2, (1, 16, 24), "db3", "periodization", 1),
     (3, (1, 9, 10, 11), "sym2", "periodic", 2)],
)
def test_cuda_glue_matches_jax(model_kernels, ndim, shape, wavelet, mode, level):  # noqa: F811
    """On the kernel path a level is one K3 launch per axis and, back, one
    K4 launch per two (lo, hi) pairs: 2 and 2 in 2d, 3 and 4 in 3d."""
    x = np.random.RandomState(48).randn(*shape)
    _round_trip(x, wavelet, mode, level, ndim, 1e-12)
    k4 = {2: 2, 3: 4}[ndim]
    assert dict(model_kernels) == {**{k: 0 for k in model_kernels}, "K3": ndim * level, "K4": k4 * level}


def _loss(pkg, x, wavelet, mode, level, weights):
    coeffs = pkg.fswavedec2(x, wavelet, mode=mode, level=level)
    rec = pkg.fswaverec2(coeffs, wavelet)
    flat = _flat(coeffs, 2) + [rec]
    return sum((c * w).sum() for c, w in zip(flat, weights))


@pytest.mark.parametrize("route", ["plain", "glue"])
@pytest.mark.parametrize("mode,shape", [("reflect", (2, 13, 16)), ("zero", (1, 16, 10))])
def test_gradients_match_jax(request, route, mode, shape):
    """Gradients through ``fswavedec2`` -> ``fswaverec2`` against
    ``jax.grad``; on the kernel path each K3 launch's VJP is one K4 launch
    and each K4 launch's one K3 launch."""
    counts = request.getfixturevalue("model_kernels") if route == "glue" else None
    rng = np.random.RandomState(49)
    x = rng.randn(*shape)
    level = 2
    jc = jptwt.fswavedec2(jnp.asarray(x), "db2", mode=mode, level=level)
    shapes = [c.shape for c in _flat(jc, 2)] + [jptwt.fswaverec2(jc, "db2").shape]
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
        assert {k: v for k, v in counts.items() if v} == {"K3": 2 * level, "K4": 2 * level}


def test_docstring_examples():
    import doctest
    import importlib

    mod = importlib.import_module("ptwt_tpu_torch.separable_conv_transform")
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0
