"""ptwt_tpu_torch.cwt and the continuous-wavelet helpers against ptwt_tpu.

The same numpy inputs, made from a seed, go through both packages on the
CPU: every family of the continuous registry and discrete wavelets sampled
by the cascade, float32 within 1e-5 of ``max(1, |coef|)`` and float64
within 1e-10; the frequencies; the grouping of scales by FFT size; integer
input; and the differentiable wavelets carried across with
``wavelet_from_numpy``, their coefficients and the gradients of both
parameters against ``jax.grad`` (float64, 1e-9 relative).  The transform
holds no hand-written kernel: on the card it runs on cuFFT through
``torch.fft``.  Also the cases of ``tests/test_cwt.py`` and
``tests/test_published_cwt.py`` on the port's registry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.continuous_transform import wavelet_from_numpy
from test_cwt import _oracle_cwt_one_scale
from test_published_cwt import NAMES, closed_form_psi
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL = {np.float32: 1e-5, np.float64: 1e-10}
DISCRETE = ["db4", "sym3", "bior2.2", "haar"]
# scales whose resampled wavelets span several FFT sizes of a 150-sample signal
SCALES = [1.5, 3.0, 7.5, 20.0, 33.0]


def _assert_coeffs(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) / scale <= tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", NAMES + DISCRETE)
def test_cwt_matches_jax(name, dtype):
    x = np.random.RandomState(0).randn(2, 150).astype(dtype)
    got, freqs = tptwt.cwt(torch.from_numpy(x), SCALES, name, sampling_period=0.01)
    want, want_freqs = jptwt.cwt(jnp.asarray(x), SCALES, name, sampling_period=0.01)
    _assert_coeffs(got, want, TOL[dtype])
    assert isinstance(freqs, np.ndarray) and freqs.dtype == np.float64
    np.testing.assert_array_equal(freqs, np.asarray(want_freqs))


@pytest.mark.parametrize("wavelet_name", ["mexh", "morl", "gaus3", "cmor1.5-1.0", "shan0.5-1.0"])
@pytest.mark.parametrize("scale", [3.0, 7.5])
def test_cwt_matches_direct_convolution(wavelet_name, scale):
    """The FFT-domain path equals the direct time-domain convolution on a
    test-local closed-form psi."""
    wavelet = tptwt.ContinuousWavelet(wavelet_name)
    x = np.random.RandomState(3).randn(128)
    got, _ = tptwt.cwt(torch.from_numpy(x), [scale], wavelet_name)
    np.testing.assert_allclose(got[0].numpy(), _oracle_cwt_one_scale(x, wavelet, scale), atol=1e-9)


def test_cwt_chirp_ridge():
    """The |CWT| ridge of a pure tone sits at scale = f_c / f."""
    fs = 100.0
    t = np.arange(0, 10, 1 / fs)
    sig = torch.from_numpy(np.sin(2 * np.pi * 5.0 * t))
    scales = np.arange(1, 31)
    coeffs, frequencies = tptwt.cwt(sig, scales, "mexh", sampling_period=1 / fs)
    power = np.mean(np.abs(coeffs.numpy()) ** 2, axis=-1)
    assert abs(scales[np.argmax(power)] - 5) <= 1
    np.testing.assert_allclose(frequencies, 0.25 / scales * fs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cwt_batched_and_complex_match_jax(dtype):
    x = np.random.RandomState(4).randn(2, 3, 256).astype(dtype)
    got, freqs = tptwt.cwt(torch.from_numpy(x), [2.0, 4.0, 8.0], "cmor1.0-0.5")
    want, _ = jptwt.cwt(jnp.asarray(x), [2.0, 4.0, 8.0], "cmor1.0-0.5")
    assert got.shape == (3, 2, 3, 256) and got.is_complex() and freqs.shape == (3,)
    assert got.dtype == (torch.complex64 if dtype == np.float32 else torch.complex128)
    _assert_coeffs(got, want, TOL[dtype])


@pytest.mark.parametrize("scale", [0.01, 0.05])
def test_cwt_scale_too_small(scale):
    with pytest.raises(ValueError, match="too small"):
        tptwt.cwt(torch.ones(64), [scale], "mexh")
    with pytest.raises(ValueError, match="too small"):
        jptwt.cwt(jnp.ones((64,)), [scale], "mexh")


@pytest.mark.parametrize("name", ["cmor1.5-1.0", "mexh"])
def test_cwt_empty_batch_matches_jax(name):
    x = np.zeros((0, 2, 128), dtype=np.float32)
    got, _ = tptwt.cwt(torch.from_numpy(x), [2.0, 40.0], name)
    want, _ = jptwt.cwt(jnp.asarray(x), [2.0, 40.0], name)
    assert tuple(got.shape) == np.asarray(want).shape == (2, 0, 2, 128)
    assert got.numpy().dtype == np.asarray(want).dtype


def test_cwt_discrete_wavelet_input():
    """Discrete wavelets are sampled via the cascade (as in pywt)."""
    x = torch.from_numpy(np.random.RandomState(6).randn(100))
    coeffs, _ = tptwt.cwt(x, [1.0, 2.0], "db4")
    assert coeffs.shape == (2, 100) and not coeffs.is_complex()


def test_cwt_wavelet_objects_match_names():
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 90))
    for name in ("morl", "sym4"):
        by_name, f1 = tptwt.cwt(x, [2.0, 5.0], name)
        by_object, f2 = tptwt.cwt(x, [2.0, 5.0], tptwt.DiscreteContinuousWavelet(name))
        assert torch.equal(by_name, by_object) and np.array_equal(f1, f2)


def _count_ffts(monkeypatch):
    calls = {"fft": 0, "ifft": 0}
    for fname in calls:
        orig = getattr(torch.fft, fname)

        def counted(*args, _orig=orig, _name=fname, **kwargs):
            calls[_name] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(torch.fft, fname, counted)
    return calls


@pytest.mark.parametrize("n,scales", [(256, np.arange(1, 33)), (1000, np.arange(1, 31)), (300, [4.0])])
def test_cwt_batches_scales_by_fft_size(monkeypatch, n, scales):
    """Per group of scales sharing a padded FFT size: one data FFT, one FFT
    of the stacked wavelet rows, one inverse FFT; so 32 scales of a
    256-sample signal take a handful of size groups, not 32 pipelines."""
    x = np.random.RandomState(0).randn(1, n)
    wav = tptwt.ContinuousWavelet("mexh")
    grid = np.linspace(wav.lower_bound, wav.upper_bound, 2**12)
    span = grid[-1] - grid[0]
    sizes = {int(2 ** np.ceil(np.log2(n + len(np.arange(s * span + 1)) - 1))) for s in np.atleast_1d(scales)}
    calls = _count_ffts(monkeypatch)
    got, _ = tptwt.cwt(torch.from_numpy(x), scales, "mexh")
    assert calls == {"fft": 2 * len(sizes), "ifft": len(sizes)}
    assert sum(calls.values()) <= 3 * len(sizes) and len(sizes) <= 4
    assert got.shape == (len(np.atleast_1d(scales)), 1, n)


@pytest.mark.parametrize("default", [torch.float64, torch.float32])
def test_cwt_integer_input_promotes_to_default_dtype(default):
    x = np.random.RandomState(8).randint(-5, 6, size=(2, 120))
    prev = torch.get_default_dtype()
    torch.set_default_dtype(default)
    try:
        got, _ = tptwt.cwt(torch.from_numpy(x), [2.0, 6.0], "gaus2")
        got_c, _ = tptwt.cwt(torch.from_numpy(x), [2.0, 6.0], "cgau2")
    finally:
        torch.set_default_dtype(prev)
    assert torch.get_default_dtype() == prev
    assert got.dtype == default
    assert got_c.dtype == (torch.complex128 if default == torch.float64 else torch.complex64)
    # ptwt_tpu promotes integers to its default float, float64 under x64
    want, _ = jptwt.cwt(jnp.asarray(x), [2.0, 6.0], "gaus2")
    want_c, _ = jptwt.cwt(jnp.asarray(x), [2.0, 6.0], "cgau2")
    tol = 1e-10 if default == torch.float64 else 1e-5
    _assert_coeffs(got.double(), want, tol)
    _assert_coeffs(got_c.to(torch.complex128), want_c, tol)


def test_cwt_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.cwt(np.zeros(64), [2.0], "mexh")


def _pair(cls_name, bandwidth, center, **kwargs):
    jwav = getattr(jptwt, cls_name).from_frequencies(bandwidth, center, **kwargs)
    params = {"bandwidth_par": np.asarray(jwav.bandwidth_par), "center_par": np.asarray(jwav.center_par)}
    return wavelet_from_numpy(getattr(tptwt, cls_name), params, **kwargs), jwav


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "name,bandwidth,center,kwargs",
    [
        ("ShannonWavelet", 1.0, 0.75, {}),
        ("ShannonWavelet", 0.1, 0.4, {"lower_bound": -20.0, "upper_bound": 20.0}),
        ("ComplexMorletWavelet", 1.5, 1.0, {}),
        ("ComplexMorletWavelet", 0.7, 0.3, {"complex_cwt": False, "name": "cmor-real"}),
    ],
)
def test_differentiable_wavelets_match_jax(name, bandwidth, center, kwargs, dtype):
    """The same parameters give the same transform, frequencies and
    gradients of both parameters (``jax.grad``; float64, 1e-9 relative)."""
    twav, jwav = _pair(name, bandwidth, center, **kwargs)
    assert isinstance(twav, torch.nn.Module) and len(list(twav.parameters())) == 2
    assert all(p.dtype == torch.float64 for p in twav.parameters())
    for field in ("lower_bound", "upper_bound", "complex_cwt", "name"):
        assert getattr(twav, field) == getattr(jwav, field)
    assert twav.center_frequency == pytest.approx(jwav.center_frequency, rel=1e-15)
    x = np.random.RandomState(5).randn(2, 128).astype(dtype)
    scales = [2.0, 4.0, 9.0]
    got, freqs = tptwt.cwt(torch.from_numpy(x), scales, twav, sampling_period=0.5)
    want, want_freqs = jptwt.cwt(jnp.asarray(x), scales, jwav, sampling_period=0.5)
    _assert_coeffs(got.detach(), want, TOL[dtype])
    np.testing.assert_allclose(freqs.detach().numpy(), np.asarray(want_freqs), rtol=1e-15)
    if dtype == np.float32:
        return

    def jloss(w):
        coeffs, f = jptwt.cwt(jnp.asarray(x), scales, w, sampling_period=0.5)
        return jnp.sum(jnp.abs(coeffs) ** 2) + jnp.sum(f)

    jgrad = jax.grad(jloss)(jwav)
    loss = (got.abs() ** 2).sum() + freqs.sum()
    bgrad, cgrad = torch.autograd.grad(loss, [twav.bandwidth_par, twav.center_par])
    for g, w in ((bgrad, jgrad.bandwidth_par), (cgrad, jgrad.center_par)):
        w = float(w)
        assert abs(float(g) - w) <= 1e-9 * abs(w)
        assert w != 0.0


def test_differentiable_wavelet_module_behaviour():
    """Squared parameters, a float center frequency, ``wavefun`` on the
    parameters' device, and an SGD step that moves both parameters."""
    wav = tptwt.ShannonWavelet.from_frequencies(0.1, 0.4)
    assert float(wav.bandwidth.detach()) == pytest.approx(0.1) and float(wav.center.detach()) == pytest.approx(0.4)
    assert isinstance(wav.center_frequency, float)
    psi, grid = wav.wavefun(8)
    assert psi.shape == grid.shape == (256,) and psi.is_complex() and grid.device == wav.center_par.device
    with pytest.raises(NotImplementedError):
        tptwt.continuous_transform._DifferentiableContinuousWavelet(1.0, 1.0)(grid)
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 200))
    opt = torch.optim.SGD(wav.parameters(), lr=1e-3)
    before = [p.detach().clone() for p in wav.parameters()]
    coeffs, _ = tptwt.cwt(x, np.arange(1, 6), wav)
    (coeffs.abs() ** 2).mean().backward()
    opt.step()
    assert all(not torch.equal(b, p) for b, p in zip(before, wav.parameters()))


@pytest.mark.parametrize("name", NAMES)
def test_port_psi_matches_closed_form(name):
    """The port's registry samples equal the published closed forms."""
    psi, x = tptwt.ContinuousWavelet(name).wavefun(10)
    np.testing.assert_allclose(np.asarray(psi), closed_form_psi(name, np.asarray(x)), atol=1e-10)


@pytest.mark.parametrize(
    "name,value", [("morl", 0.8125), ("mexh", 0.25), ("cmor1.5-1.0", 1.0), ("shan1.5-1.0", 1.0), ("db4", 5 / 7)]
)
def test_central_frequency_matches_jax(name, value):
    got = tptwt.central_frequency(name, precision=12)
    assert got == jptwt.central_frequency(name, precision=12)
    assert abs(got - value) < 5e-3
    np.testing.assert_array_equal(
        tptwt.scale2frequency(name, np.arange(1, 5), precision=10),
        jptwt.scale2frequency(name, np.arange(1, 5), precision=10),
    )
