"""ptwt_tpu_torch.swt/iswt against ptwt_tpu on the CPU.

The same numpy inputs, made from a seed, go through both packages.  The
stationary transform runs no kernel in either package: on both devices
the port's version is plain torch ops (a tap loop of dilated slices and a
modulo index gather for the circular pad).  Tolerances: float32 2e-5,
float64 1e-12.  Also the cases of ``tests/test_swt.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu.wavelets import Wavelet as JWavelet
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL = {np.float32: 2e-5, np.float64: 1e-12}
# the JAX reference under jit: one compile per configuration instead of
# one per primitive and shape
J_SWT = jax.jit(jptwt.swt, static_argnums=(1, 2), static_argnames=("axis",))
J_ISWT = jax.jit(jptwt.iswt, static_argnums=(1,), static_argnames=("axis",))


def _assert_list(got, want, tol):
    assert isinstance(got, list) and len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


def _round_trip(x, wavelet, level, tol, axis=None):
    want = J_SWT(jnp.asarray(x), wavelet, level, axis=axis)
    got = tptwt.swt(torch.from_numpy(x), wavelet, level, axis=axis)
    _assert_list(got, want, tol)
    rec_want = np.asarray(J_ISWT(want, wavelet, axis=axis))
    rec = tptwt.iswt(got, wavelet, axis=axis)
    assert tuple(rec.shape) == rec_want.shape and rec.dtype == got[0].dtype
    np.testing.assert_allclose(rec.numpy(), rec_want, atol=tol, rtol=0)
    return rec


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "wavelet,shape,level",
    [
        ("haar", (2, 32), 3),
        ("db2", (3, 64), 4),
        ("db4", (2, 48), 2),
        ("sym5", (1, 40), 3),
        ("coif3", (2, 36), 2),
        ("bior2.2", (2, 24), 3),
    ],
)
def test_swt_iswt_match_jax(wavelet, shape, level, dtype):
    x = np.random.RandomState(50).randn(*shape).astype(dtype)
    rec = _round_trip(x, wavelet, level, TOL[dtype])
    if wavelet != "bior2.2":
        np.testing.assert_allclose(rec.numpy(), x, atol=10 * TOL[dtype], rtol=0)


@pytest.mark.parametrize(
    "wavelet,n,level",
    # the circular pad wraps the signal several times: db2 at level 10 pads
    # 512 samples on a 64-sample signal, coif17's 102 taps reach past 7
    [("db2", 64, 10), ("db6", 16, 4), ("coif17", 8, 3), ("sym8", 12, 2)],
)
def test_long_filters_on_short_signals_match_jax(wavelet, n, level):
    x = np.random.RandomState(51).randn(2, n)
    rec = _round_trip(x, wavelet, level, 1e-12)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10, rtol=0)


@pytest.mark.parametrize("n", [31, 33, 45])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_odd_lengths_match_jax(n, dtype):
    """swt needs no even length: every level keeps the input length."""
    x = np.random.RandomState(52).randn(3, n).astype(dtype)
    _round_trip(x, "db3", 2, TOL[dtype])


@pytest.mark.parametrize("axis", [0, 1, -2])
def test_axis_argument_matches_jax(axis):
    x = np.random.RandomState(53).randn(16, 24, 3)
    rec = _round_trip(x, "sym3", 2, 1e-12, axis=axis)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10, rtol=0)


def test_batch_of_several_dims_matches_jax():
    x = np.random.RandomState(54).randn(2, 3, 4, 32)
    _round_trip(x, "db2", 3, 1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_empty_batch_matches_jax(dtype):
    x = np.zeros((0, 32), dtype=dtype)
    rec = _round_trip(x, "db2", 2, 0.0)
    assert tuple(rec.shape) == (0, 32)


@pytest.mark.parametrize("n,wavelet", [(32, "db2"), (48, "haar"), (40, "sym4"), (7, "db1")])
def test_default_level_matches_jax(n, wavelet):
    """The default level is ``swt_max_level`` of the length: the times it
    halves exactly (0 for an odd length, which returns ``[x]``)."""
    assert tptwt.swt_max_level(n) == jptwt.swt_max_level(n)
    x = np.random.RandomState(55).randn(2, n)
    _round_trip(x, wavelet, None, 1e-12)
    assert len(tptwt.swt(torch.from_numpy(x), wavelet)) == tptwt.swt_max_level(n) + 1


def test_unsupported_dtype_raises():
    with pytest.raises(ValueError, match="dtype"):
        tptwt.swt(torch.zeros(2, 16, dtype=torch.float16), "haar", 1)


def test_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.swt(np.zeros((2, 16), dtype=np.float32), "haar", 1)


def _loss(pkg, x, wavelet, level, weights):
    coeffs = pkg.swt(x, wavelet, level)
    rec = pkg.iswt(coeffs, wavelet)
    return sum((c * w).sum() for c, w in zip([*coeffs, rec], weights))


@pytest.mark.parametrize("wavelet,shape,level", [("db2", (2, 32), 3), ("sym4", (1, 20), 4)])
def test_gradients_match_jax(wavelet, shape, level):
    rng = np.random.RandomState(56)
    x = rng.randn(*shape)
    weights = [rng.randn(*shape) for _ in range(level + 2)]
    want = jax.jit(jax.grad(lambda z: _loss(jptwt, z, wavelet, level, [jnp.asarray(w) for w in weights])))(
        jnp.asarray(x)
    )
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(_loss(tptwt, xt, wavelet, level, [torch.from_numpy(w) for w in weights]), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)


def test_filter_gradients_reach_a_tensor_bank():
    """A filter bank given as tensors keeps its gradient path."""
    bank = tptwt.WaveletTensorTuple.from_wavelet(tptwt.RegistryWavelet("db2"), dtype=torch.float64)
    bank = tptwt.WaveletTensorTuple(*(f.clone().requires_grad_() for f in bank))
    x = torch.from_numpy(np.random.RandomState(57).randn(2, 16))
    loss = sum((c**2).sum() for c in tptwt.swt(x, bank, 2))
    grads = torch.autograd.grad(loss, [bank.dec_lo, bank.dec_hi])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


# ---------------------------------------------------------------------------
# the cases of tests/test_swt.py
# ---------------------------------------------------------------------------


def _oracle_swt_level(x, dec_lo, dec_hi, dilation):
    """Direct numpy dilated circular filter bank (independent oracle)."""
    n = x.shape[-1]
    filt_len = len(dec_lo)
    lo = np.zeros_like(x)
    hi = np.zeros_like(x)
    padl = dilation * (filt_len // 2 - 1)
    for k in range(n):
        for j in range(filt_len):
            idx = (k - padl + j * dilation) % n
            lo[..., k] += dec_lo[::-1][j] * x[..., idx]
            hi[..., k] += dec_hi[::-1][j] * x[..., idx]
    return lo, hi


def test_swt_haar_golden():
    x = np.arange(8, dtype=np.float64)
    coeffs = tptwt.swt(torch.from_numpy(x), "haar", level=1)
    s = np.sqrt(2.0) / 2.0
    np.testing.assert_allclose(coeffs[0].numpy(), s * (x + np.roll(x, -1)), atol=1e-12)
    np.testing.assert_allclose(coeffs[1].numpy(), s * (x - np.roll(x, -1)), atol=1e-12)


@pytest.mark.parametrize("wavelet_name", ["haar", "db2", "db4", "sym3"])
def test_swt_oracle_parity(wavelet_name):
    wavelet = JWavelet(wavelet_name)
    dec_lo, dec_hi = np.array(wavelet.dec_lo), np.array(wavelet.dec_hi)
    x = np.random.RandomState(5).randn(32)
    coeffs = tptwt.swt(torch.from_numpy(x), wavelet_name, level=2)
    lo1, hi1 = _oracle_swt_level(x, dec_lo, dec_hi, 1)
    np.testing.assert_allclose(coeffs[-1].numpy(), hi1, atol=1e-11)
    lo2, hi2 = _oracle_swt_level(lo1, dec_lo, dec_hi, 2)
    np.testing.assert_allclose(coeffs[1].numpy(), hi2, atol=1e-11)
    np.testing.assert_allclose(coeffs[0].numpy(), lo2, atol=1e-11)


@pytest.mark.parametrize("wavelet_name", ["haar", "db2", "db3", "sym4", "coif2"])
@pytest.mark.parametrize("level", [1, 2, 3, None])
def test_iswt_roundtrip(wavelet_name, level):
    x = np.random.RandomState(6).randn(2, 64)
    coeffs = tptwt.swt(torch.from_numpy(x), wavelet_name, level=level)
    np.testing.assert_allclose(tptwt.iswt(coeffs, wavelet_name).numpy(), x, atol=1e-10)


def test_swt_shapes_and_axis():
    x = np.random.RandomState(7).randn(3, 4, 32)
    coeffs = tptwt.swt(torch.from_numpy(x), "db2", level=3)
    assert len(coeffs) == 4 and all(tuple(c.shape) == (3, 4, 32) for c in coeffs)
    coeffs_ax = tptwt.swt(torch.from_numpy(x), "db2", level=2, axis=1)
    np.testing.assert_allclose(tptwt.iswt(coeffs_ax, "db2", axis=1).numpy(), x, atol=1e-10)


def test_docstring_examples():
    import doctest
    import importlib

    mod = importlib.import_module("ptwt_tpu_torch.stationary_transform")
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0
