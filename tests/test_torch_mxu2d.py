"""K9 of ptwt_tpu_torch (the tensor-core 2d level) against the JAX package.

K9a/K9b run only with the opt-in ``PTWT_TPU_MXU2D=1`` (set here with
``monkeypatch``).  On the CPU a level that K9 would take runs K9's plain
versions (the banded-window GEMM form, ``ops/_mxu2d.py``); they are held
against the JAX package's K9 (``ptwt_tpu.ops._mxu2d``) in Pallas interpret
mode, called as ``tests/test_mxu2d.py`` calls it, within 5e-5 in float32
(that test's tolerance), and in float64 (where the JAX K9 computes in
float32) against the JAX package's level route within 1e-10.  The CUDA glue (the K1/K2
launch arguments K9 takes, and its VJPs) runs on the numpy model of
``tests/test_torch_kernels.py`` against ``jax.grad`` through the JAX
package's ``_level_calls`` with its K9 selected.  The kernels themselves
meet their plain versions on the card in ``tests/test_torch_cuda.py``.
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
from ptwt_tpu.ops import _mxu2d as j9
from ptwt_tpu.ops import _pallas2d as j2d
from ptwt_tpu.ops._dispatch import analysis_nd as j_analysis_nd
from ptwt_tpu.ops._dispatch import synthesis_nd as j_synthesis_nd
from ptwt_tpu.wavelets import Wavelet
from ptwt_tpu_torch.ops import _kernels, analysis_nd, synthesis_nd
from ptwt_tpu_torch.ops import _mxu2d as t9
from ptwt_tpu_torch.ops import _pallas2d as t2d
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL32 = 5e-5
TOL64 = 1e-10


@pytest.fixture
def opt_in(monkeypatch):
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _filters(name):
    """Correlation-order analysis and plain synthesis taps, as
    ``tests/test_mxu2d.py`` takes them."""
    w = Wavelet(name)
    lo = tuple(float(v) for v in np.asarray(w.dec_lo)[::-1])
    hi = tuple(float(v) for v in np.asarray(w.dec_hi)[::-1])
    rlo = tuple(float(v) for v in np.asarray(w.rec_lo))
    rhi = tuple(float(v) for v in np.asarray(w.rec_hi))
    return lo, hi, rlo, rhi


# ---------------------------------------------------------------------------
# the plain versions against the JAX K9 (interpret mode)
# ---------------------------------------------------------------------------


NAMES = ["haar", "db4", "db8", "sym6", "db20"]
SHAPES = [(2, 128, 256), (1, 256, 512)]


def shape_ids(indices):
    """The ids pytest gives ``SHAPES[i]`` in a parametrisation over all of
    them: the checks at ``(1, 256, 512)`` run in files of their own
    (``test_torch_mxu2d_f32_*.py``, ``test_torch_mxu2d_f64_*.py``), so
    that the test run spreads them over its workers, and keep their ids."""
    return [f"shape{i}" for i in indices]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES[:1], ids=shape_ids([0]))
def test_mxu2_plain_matches_jax(name, shape):
    check_plain(name, shape)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES[:1], ids=shape_ids([0]))
def test_mxu2_plain_float64_matches_jax(name, shape):
    check_plain_float64(name, shape)


def check_plain(name, shape):
    """K9's plain versions against the JAX K9 in interpret mode, float32."""
    lo, hi, rlo, rhi = _filters(name)
    L = len(lo)
    _, h, w = shape
    tol = TOL32
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    for pad in sorted({L // 2 - 1, (2 * L - 3) // 2}):
        want = np.asarray(j9.mxu2_dwt_call(jnp.asarray(x), lo, hi, pad))  # [b, 4, h/2, w/2]
        # the port's K1 launch contract: m = (n + 2 pad - L) // 2 + 1 bands
        # read modulo the period, the snug band and the wrap entries
        m_h, m_w = (h + 2 * pad - L) // 2 + 1, (w + 2 * pad - L) // 2 + 1
        got = t9.mxu2_dwt_plain(torch.from_numpy(x), lo, hi, h, w, m_h, m_w, pad).transpose(0, 1)
        _close(got[..., : h // 2, : w // 2], want, tol)
        rows = np.arange(h // 2, m_h) % (h // 2)
        cols = np.arange(w // 2, m_w) % (w // 2)
        _close(got[..., h // 2 :, : w // 2], want[..., rows, :], tol)
        _close(got[..., : h // 2, w // 2 :], want[..., cols], tol)
        # the circular synthesis of the snug band
        rec = np.asarray(j9.mxu2_idwt_call(jnp.asarray(want), rlo, rhi, pad))
        snug = [torch.from_numpy(want[:, i].copy()) for i in range(4)]
        got_rec = t9.mxu2_idwt_plain(snug, rlo, rhi, h, w, pad, True)
        _close(got_rec, rec, tol)
        if pad == L // 2 - 1:
            _close(got_rec, x, tol)


def check_plain_float64(name, shape):
    """Float64 through the plain versions with the K1/K2 launch contract
    (the JAX K9 computes in float32), against the JAX package's level
    route in the mode each pad belongs to."""
    dl, dh, rl, rh = _banks(name, np.float64)
    L = len(dl)
    _, h, w = shape
    x = np.random.RandomState(4).randn(*shape)
    for mode, pad in (("periodization", L // 2 - 1), ("periodic", (2 * L - 3) // 2)):
        want = j_analysis_nd(jnp.asarray(x), dl, dh, mode=mode, ndim=2)
        m_h, m_w = want[0].shape[-2:]
        got = t9.mxu2_dwt_plain(torch.from_numpy(x), dl.tolist(), dh.tolist(), h, w, m_h, m_w, pad)
        for g, wb in zip(got, want):
            _close(g, wb, TOL64)
        crop = 0 if mode == "periodization" else pad
        rec = j_synthesis_nd(want, rl, rh, pads=[(crop, crop)] * 2, mode=mode, ndim=2)
        bands = [torch.from_numpy(np.array(wb)) for wb in want]
        got_rec = t9.mxu2_idwt_plain(bands, rl.tolist(), rh.tolist(), h, w, pad, mode == "periodization")
        _close(got_rec, rec, TOL64)
        _close(got_rec, x, TOL64)


# ---------------------------------------------------------------------------
# the public path and the level entry points with the opt-in
# ---------------------------------------------------------------------------


def _spy(monkeypatch):
    """Count the calls of K9's plain versions on the public path."""
    calls = {"a": 0, "b": 0}
    for key, name in (("a", "mxu2_dwt_plain"), ("b", "mxu2_idwt_plain")):
        fn = getattr(t2d, name)

        def counted(*args, _fn=fn, _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(t2d, name, counted)
    return calls


@pytest.mark.parametrize("wavelet", ["db4", "sym6"])
def test_public_periodic_with_opt_in_matches_jax(opt_in, monkeypatch, wavelet):
    x = np.random.RandomState(1).randn(2, 128, 256).astype(np.float32)
    calls = _spy(monkeypatch)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode="periodic", level=2)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode="periodic", level=2)
    for g, w in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        _close(g, w, TOL32)
    rec = tptwt.waverec2(got, wavelet, mode="periodic")
    _close(rec, jptwt.waverec2(want, wavelet, mode="periodic"), TOL32)
    _close(rec, x, TOL32)
    # level 1 (128 x 256) only: level 2 is odd
    assert calls == {"a": 1, "b": 1}


@pytest.mark.parametrize("wavelet", ["db4", "db20"])
def test_periodization_level_with_opt_in_matches_jax(opt_in, monkeypatch, wavelet):
    """An exactly halving periodization chain goes to K5 before any level
    is routed, so the level entry points carry the check; the JAX side
    runs its K9 in interpret mode (the opt-in is set for both)."""
    dl, dh, rl, rh = _banks(wavelet)
    x = np.random.RandomState(2).randn(1, 256, 256).astype(np.float32)
    calls = _spy(monkeypatch)
    want = j2d.fused2_dwt_level(jnp.asarray(x), dl, dh, "periodization")
    got = analysis_nd(torch.from_numpy(x), dl, dh, mode="periodization", ndim=2)
    for g, w in zip(got, want):
        _close(g, w, TOL32)
    bands = [torch.from_numpy(np.array(w)) for w in want]
    rec = synthesis_nd(bands, rl, rh, pads=[(0, 0)] * 2, mode="periodization", ndim=2)
    _close(rec, j2d.fused2_idwt_level(want, rl, rh, "periodization"), TOL32)
    _close(rec, x, TOL32)
    assert calls == {"a": 1, "b": 1}


# ---------------------------------------------------------------------------
# the CUDA glue on the numpy model of the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opted", [True, False])
@pytest.mark.parametrize(
    "shape,wavelet,mode,used",
    [
        # level 1 takes K9; level 2 (odd) K3/K4
        ((1, 128, 256), "db4", "periodic", "K9a K9b K3 K4"),
        ((1, 128, 256), "haar", "periodic", "K9a K9b K1 K2"),
    ],
)
def test_cuda_glue_launches_k9(model_kernels, monkeypatch, opted, shape, wavelet, mode, used):  # noqa: F811
    if opted:
        monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    else:
        used = used.replace("K9a", "K1").replace("K9b", "K2")
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode=mode, level=2)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode=mode, level=2)
    for g, w in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        _close(g, w, TOL32)
    rec = tptwt.waverec2(got, wavelet, mode=mode)
    _close(rec, jptwt.waverec2(want, wavelet, mode=mode), TOL32)
    assert {k for k, v in model_kernels.items() if v} == set(used.split())
    assert model_kernels["K9a"] == model_kernels["K9b"] == (1 if opted else 0)


@pytest.mark.parametrize("mode", ["periodization", "periodic"])
def test_k9_vjps_match_jax(model_kernels, monkeypatch, mode):  # noqa: F811
    """K9a's VJP (K9b with the fold of the periodic wrap rows) and K9b's
    (K9a, zero-bounded for periodic) against ``jax.grad`` through the JAX
    package's ``_level_calls``, whose K9 runs in interpret mode both
    ways."""
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    dl, dh, rl, rh = _banks("db4")
    x = np.random.RandomState(9).randn(1, 128, 256).astype(np.float32)

    def loss_jax(inp):
        bands = j2d.fused2_dwt_level(inp, dl, dh, mode)
        rec = j2d.fused2_idwt_level(bands, rl, rh, mode)
        return jnp.sum(rec**2) + sum(jnp.sum(jnp.cos(b)) for b in bands)

    want = jax.grad(loss_jax)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    bands = t2d.fused2_dwt_level(xt, dl, dh, mode)
    rec = t2d.fused2_idwt_level(bands, rl, rh, mode)
    loss = (rec**2).sum() + sum(torch.cos(b).sum() for b in bands)
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, want, 5e-4)
    assert {k: v for k, v in model_kernels.items() if v} == {"K9a": 2, "K9b": 2}


def test_k9_refuses_float64_and_filter_grads(model_kernels, opt_in):  # noqa: F811
    """Float64 stays on K1/K2; on the kernel path a filter that requires
    grad raises; on the CPU it keeps the per-axis plain path, which carries
    the filter gradient."""
    dl, dh, _, _ = _banks("db4", np.float64)
    x = torch.randn(1, 128, 256, dtype=torch.float64)
    t2d.fused2_dwt_level(x, dl, dh, "periodic")
    assert {k: v for k, v in model_kernels.items() if v} == {"K1": 1}
    learn = torch.tensor(dl, dtype=torch.float32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t2d.fused2_dwt_level(x.float(), learn, dh, "periodic")
    with pytest.raises(ValueError, match="float32 only"):
        t9.mxu2_dwt_call(x, dl, dh, 128, 256, 67, 131, 6)


def test_cpu_filter_grads_bypass_k9(opt_in):
    _, dh, _, _ = _banks("db4")
    dl = torch.tensor(_banks("db4")[0], requires_grad=True)
    x = torch.randn(1, 128, 256)
    bands = t2d.fused2_dwt_level(x, dl, dh, "periodic")
    (grad,) = torch.autograd.grad(sum(b.sum() for b in bands), dl)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def test_mxu2_gates(monkeypatch):
    """``tests/test_mxu2d.py::test_mxu2_gates``, plus float64 and the
    shapes the JAX 8 MB cap refused, which the port takes."""
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    assert t9.mxu2_analysis_ok(128, 256, 8)
    assert not t9.mxu2_analysis_ok(128, 200, 8)
    assert not t9.mxu2_analysis_ok(100, 256, 8)
    assert not t9.mxu2_synthesis_ok(60, 128, 8)
    assert not t9.mxu2_analysis_ok(128, 256, 80)
    assert t9.mxu2_analysis_ok(128, 256, 64) and not t9.mxu2_analysis_ok(128, 256, 65)
    assert t9.mxu2_synthesis_ok(64, 128, 8)
    # every level the JAX gate takes, and the headline's 1024^2 beyond its cap
    for h, w in ((128, 256), (256, 512), (1024, 1024), (2048, 2048)):
        assert t9.mxu2_analysis_ok(h, w, 8)
        assert t9.mxu2_level_ok(h, w, 8, torch.float32)
        assert not t9.mxu2_level_ok(h, w, 8, torch.float64)
    assert not j9.mxu2_analysis_ok(2048, 2048, 8)
    # the headline's other levels stay on K1/K3
    for n in (515, 261, 134):
        assert not t9.mxu2_level_ok(n, n, 8, torch.float32)
    monkeypatch.delenv("PTWT_TPU_MXU2D")
    assert not t9.mxu2_enabled()
    assert not t9.mxu2_level_ok(1024, 1024, 8, torch.float32)
    _kernels.reset_launch_counts()
