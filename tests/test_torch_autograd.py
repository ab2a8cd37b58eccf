"""Gradients through ptwt_tpu_torch's kernel path against the JAX package.

The CUDA glue of every autograd Function (K3/K4 and K1/K2, each pair
each other's VJP) runs here on the CPU against the numpy model of the
kernels' index arithmetic (``model_kernels`` of ``test_torch_kernels``),
whose VJP entries are the transposes of the forward operators.  It is
held against ``jax.grad`` through the JAX package's Pallas kernels in
interpret mode, as ``tests/test_pallas2.py`` and ``tests/test_pallas2d.py``
call them, and through the public ``wavedec2``/``waverec2``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _banks, _model_launch, model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu.ops import _pallas2 as j2
from ptwt_tpu.ops import _pallas2d as j2d
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d
from _torch_one_thread import one_torch_thread  # noqa: F401


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _flat(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


# ---------------------------------------------------------------------------
# (a) each Function's VJP glue against the JAX kernels' own VJPs (float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,shape,axis",
    [
        ("reflect", (4, 66), -1),
        ("periodization", (4, 66), -1),
        ("periodic", (4, 67), -1),
        ("symmetric", (3, 21, 5), -2),
        ("periodization", (3, 21, 5), -2),
    ],
)
def test_analysis_vjp_matches_jax_kernel(model_kernels, mode, shape, axis):  # noqa: F811
    dl, dh, _, _ = _banks("db2", np.float64)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)

    def loss_jax(z):
        lo, hi = j2.pallas_dwt_axis(z, axis, dl, dh, mode)
        return jnp.sum(lo**2) + 0.5 * jnp.sum(hi**2)

    want = jax.grad(loss_jax)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    lo, hi = t2.pallas_dwt_axis(xt, axis, dl, dh, mode)
    (got,) = torch.autograd.grad((lo**2).sum() + 0.5 * (hi**2).sum(), xt)
    _close(got, want, 2e-5)
    # K3's VJP is one launch of K4's fold instance
    assert model_kernels["K3"] == 1 and model_kernels["K4"] == 1


@pytest.mark.parametrize("mode", ["reflect", "periodization"])
def test_synthesis_vjp_matches_jax_kernel(model_kernels, mode):  # noqa: F811
    _, _, rl, rh = _banks("db2", np.float64)
    rng = np.random.RandomState(6)
    lo = rng.randn(3, 34).astype(np.float32)
    hi = rng.randn(3, 34).astype(np.float32)
    pad = 0 if mode == "periodization" else len(rl) - 2

    def loss_jax(a, b):
        return jnp.sum(j2.pallas_idwt_axis(a, b, -1, rl, rh, pad, pad, mode) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(lo), jnp.asarray(hi))
    a = torch.from_numpy(lo).requires_grad_()
    b = torch.from_numpy(hi).requires_grad_()
    out = t2.pallas_idwt_axis([a], [b], -1, rl, rh, pad, pad, mode)
    got = torch.autograd.grad((out**2).sum(), (a, b))
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    # K4's VJP is one launch of K3, zero-bounded
    assert model_kernels["K4"] == 1 and model_kernels["K3"] == 1


@pytest.mark.parametrize("mode", ["periodization", "periodic"])
def test_fused2_vjps_match_jax_kernels(model_kernels, mode):  # noqa: F811
    """K1's VJP (K2 with the fold) and K2's VJP (K1, zero-bounded for
    periodic) against the JAX package's ``_level_calls`` pair."""
    dl, dh, rl, rh = _banks("db2")
    x = np.random.RandomState(9).randn(1, 16, 256).astype(np.float32)

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
    assert model_kernels["K1"] == 2 and model_kernels["K2"] == 2


# ---------------------------------------------------------------------------
# (b) the public path: wavedec2 -> waverec2, float64
# ---------------------------------------------------------------------------

_VJP_OF = {"K1": "K2", "K2": "K1", "K3": "K4", "K4": "K3"}


def _public_loss(lib, x, wavelet, mode, weights):
    """A loss that sends a different cotangent into every band and the
    reconstruction."""
    coeffs = lib.wavedec2(x, wavelet, mode=mode, level=2)
    rec_mode = mode if mode in ("periodic", "periodization") else None
    rec = lib.waverec2(coeffs, wavelet, mode=rec_mode)
    total = 0.5 * (rec**2).sum()
    for c, w in zip(_flat(coeffs), weights):
        total = total + (c * w).sum() + 0.25 * (c**2).sum()
    return total


@pytest.mark.parametrize(
    "shape,wavelet,mode,used",
    [
        ((1, 66, 70), "db3", "periodic", "K1 K2 K3 K4"),
        ((1, 40, 36), "db2", "periodic", "K1 K2 K3 K4"),
        ((2, 31, 33), "db4", "periodization", "K1 K2 K4"),
        ((1, 14, 18), "sym5", "periodization", "K1 K2 K3 K4"),
        ((2, 31, 33), "db2", "reflect", "K3 K4"),
        ((1, 20, 17), "db4", "symmetric", "K3 K4"),
        ((1, 19, 20), "haar", "zero", "K3 K4"),
        ((1, 18, 18), "bior2.2", "constant", "K3 K4"),
        # 102 taps on 37 samples: the transposed reads wrap several periods
        ((1, 37, 40), "coif17", "periodization", "K3 K4"),
    ],
)
def test_public_gradients_match_jax(model_kernels, shape, wavelet, mode, used):  # noqa: F811
    rng = np.random.RandomState(11)
    x = rng.randn(*shape)
    shapes = [c.shape for c in _flat(jptwt.wavedec2(jnp.asarray(x), wavelet, mode=mode, level=2))]
    weights = [rng.randn(*s) for s in shapes]
    want = jax.grad(
        lambda z: _public_loss(jptwt, z, wavelet, mode, [jnp.asarray(w) for w in weights])
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = _public_loss(tptwt, xt, wavelet, mode, [torch.from_numpy(w) for w in weights])
    assert {k for k, v in model_kernels.items() if v} == set(used.split())
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, want, 1e-10)
    assert {k for k, v in model_kernels.items() if v} == {_VJP_OF[k] for k in used.split()}


# ---------------------------------------------------------------------------
# (c) gradcheck through the kernel path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,wavelet,mode",
    # even periodic (K1 with its wrap rows, K3 on the odd level) and odd
    # periodization (K1's clamped last sample)
    [((1, 12, 14), "db2", "periodic"), ((1, 13, 11), "db2", "periodization")],
)
def test_gradcheck_kernel_path(model_kernels, shape, wavelet, mode):  # noqa: F811
    x = torch.randn(*shape, dtype=torch.float64, generator=torch.Generator().manual_seed(3))

    def fn(inp):
        coeffs = tptwt.wavedec2(inp, wavelet, mode=mode, level=2)
        return (*_flat(coeffs), tptwt.waverec2(coeffs, wavelet, mode=mode))

    assert torch.autograd.gradcheck(fn, (x.requires_grad_(),))
    assert model_kernels["K2"] and model_kernels["K1"]


# ---------------------------------------------------------------------------
# (d) a small twin of chip_smoke.py's training phase
# ---------------------------------------------------------------------------

TWIN_SHAPE = (2, 64, 64)
TWIN_LEVEL = 3
TWIN_STEPS = 3


def _twin_loss(lib, u, g, y, mode):
    """``mean((waverec2(cA, g * details) - y)^2) + 1e-3 mean(details^2)``."""
    coeffs = lib.wavedec2(u, "db4", mode=mode, level=TWIN_LEVEL)
    details = coeffs[1:]
    scaled = [tuple(g[lev, o] * d for o, d in enumerate(t)) for lev, t in enumerate(details)]
    rec = lib.waverec2((coeffs[0], *scaled), "db4", mode=mode)
    energy = sum((d**2).sum() for t in details for d in t)
    count = sum(d.size if lib is jptwt else d.numel() for t in details for d in t)
    return ((rec - y) ** 2).mean() + 1e-3 * energy / count


def _twin_lrs():
    # per-pixel gradients of a mean scale as 1/numel
    return 0.25 * float(np.prod(TWIN_SHAPE)), 0.5


@pytest.mark.parametrize("mode", ["periodic", "reflect"])
def test_training_twin_matches_jax(monkeypatch, mode):
    rng = np.random.RandomState(21)
    u0 = rng.randn(*TWIN_SHAPE)
    y = rng.randn(*TWIN_SHAPE)
    lr_u, lr_g = _twin_lrs()

    grad_fn = jax.jit(jax.value_and_grad(
        lambda u, g: _twin_loss(jptwt, u, g, jnp.asarray(y), mode), argnums=(0, 1)
    ))
    ju, jg = jnp.asarray(u0), jnp.ones((TWIN_LEVEL, 3))
    want = []
    for _ in range(TWIN_STEPS):
        loss, (gu, gg) = grad_fn(ju, jg)
        ju, jg = ju - lr_u * gu, jg - lr_g * gg
        want.append((float(loss), np.asarray(ju), np.asarray(jg)))

    def torch_run():
        u = torch.nn.Parameter(torch.from_numpy(u0.copy()))
        g = torch.nn.Parameter(torch.ones(TWIN_LEVEL, 3, dtype=torch.float64))
        opt = torch.optim.SGD([{"params": [u], "lr": lr_u}, {"params": [g], "lr": lr_g}])
        got = []
        for _ in range(TWIN_STEPS):
            opt.zero_grad()
            loss = _twin_loss(tptwt, u, g, torch.from_numpy(y), mode)
            loss.backward()
            opt.step()
            got.append((loss.item(), u.detach().clone(), g.detach().clone()))
        return got

    plain = torch_run()
    # the same steps down the CUDA glue, on the numpy model of the kernels
    monkeypatch.setattr(t2, "_on_cpu", lambda t: False)
    monkeypatch.setattr(t2d, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "launch", _model_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    _kernels.reset_launch_counts()
    kernel = torch_run()
    assert _kernels.LAUNCHES["K3"] and _kernels.LAUNCHES["K4"]
    _kernels.reset_launch_counts()
    for step, (want_loss, want_u, want_g) in enumerate(want):
        for run in (plain, kernel):
            loss, u, g = run[step]
            assert abs(loss - want_loss) <= 1e-10 * max(1.0, abs(want_loss))
            _close(u, want_u, 1e-10)
            _close(g, want_g, 1e-10)
    assert want[-1][0] < want[0][0]
