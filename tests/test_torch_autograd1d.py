"""Gradients through the 1d pyramid kernels (K6, K7, K8) against the JAX package.

The autograd Functions around K6a/K6b, K7a/K7b and K8a/K8b (each pair
the other's VJP: one launch of the other pyramid kernel, the fold of the
padding gather included) run their CUDA glue here on the CPU, on the
numpy model of the kernels (``model_kernels`` of
``tests/test_torch_kernels.py``, which runs the pyramid kernels block by
block and the K3/K4 entries, their VJP instances included, as sparse
operators, so
70,001-sample lanes fit).  They are held against ``jax.grad`` through ``ptwt_tpu.wavedec``
/ ``waverec`` in float64 within 1e-10, every padded mode, with the
launches of each backward counted; and K6's VJPs against ``jax.grad``
through the JAX package's K6 kernels in Pallas interpret mode (float32,
as ``tests/test_pallas.py`` checks them).
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
from ptwt_tpu.ops import _pallas as j6
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from _torch_one_thread import one_torch_thread  # noqa: F401

PADDED = ["zero", "reflect", "periodic", "symmetric", "constant"]


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _used(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# K6: the VJP glue against the JAX package's K6 pair (interpret, float32)
# ---------------------------------------------------------------------------


def test_k6_vjps_match_jax_kernel(model_kernels):  # noqa: F811
    dl, dh, rl, rh = _banks("db3")
    x = np.random.RandomState(4).randn(2, 2**11).astype(np.float32)

    def loss_jax(t):
        return sum(jnp.sum(jnp.sin(c)) for c in j6.fused_wavedec1d_per(t, dl, dh, 3))

    xt = torch.from_numpy(x).requires_grad_()
    loss = sum(torch.sin(c).sum() for c in t6.fused_wavedec1d_per(xt, dl, dh, 3))
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, jax.grad(loss_jax)(jnp.asarray(x)), 2e-5)
    assert _used(model_kernels) == {"K6b": 1}

    coeffs = j6.fused_wavedec1d_per(jnp.asarray(x), dl, dh, 3)

    def rloss_jax(cs):
        return jnp.sum(jnp.sin(j6.fused_waverec1d_per(list(cs), rl, rh)))

    want = jax.grad(rloss_jax)(tuple(coeffs))
    leaves = [torch.from_numpy(np.array(c)).requires_grad_() for c in coeffs]
    loss = torch.sin(t6.fused_waverec1d_per(leaves, rl, rh)).sum()
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    assert _used(model_kernels) == {"K6a": 1}


# ---------------------------------------------------------------------------
# the public path: wavedec -> waverec, float64, every route
# ---------------------------------------------------------------------------


def _public_loss(lib, x, mode, level, weights):
    """A loss that sends a different cotangent into every band and the
    reconstruction."""
    coeffs = lib.wavedec(x, "db5", mode=mode, level=level)
    rec = lib.waverec(coeffs, "db5", mode=mode if mode == "periodization" else None)
    total = 0.5 * (rec**2).sum()
    for c, w in zip(coeffs, weights):
        total = total + (c * w).sum() + 0.25 * (c**2).sum()
    return total


@pytest.mark.parametrize(
    "mode,n,level,forward,backward",
    [
        # levels 1-4 in one K8a launch, 5-6 on K3; their VJPs are one K8b
        # launch and two K4 (K3's VJP), and waverec's (two K4 steps, one
        # K8b run) two K3 (K4's VJP) and one K8a
        *[
            (m, 70001, 6, {"K8a": 1, "K3": 2, "K4": 2, "K8b": 1}, {"K3": 2, "K4": 2, "K8a": 1, "K8b": 1})
            for m in PADDED
        ],
        ("reflect", 70001, 1, {"K7a": 1, "K7b": 1}, {"K7a": 1, "K7b": 1}),
        ("periodic", 70000, 3, {"K8a": 1, "K8b": 1}, {"K8a": 1, "K8b": 1}),
        # three runs (4 + 4 + 2 levels) each way; each run's VJP is one
        # launch of the other kernel
        ("periodization", 4096, 10, {"K6a": 3, "K6b": 3}, {"K6b": 3, "K6a": 3}),
    ],
)
def test_public_gradients_match_jax(model_kernels, mode, n, level, forward, backward):  # noqa: F811
    rng = np.random.RandomState(11)
    x = rng.randn(2, n)
    shapes = [c.shape for c in jptwt.wavedec(jnp.asarray(x), "db5", mode=mode, level=level)]
    weights = [rng.randn(*s) for s in shapes]
    want = jax.grad(lambda z: _public_loss(jptwt, z, mode, level, [jnp.asarray(w) for w in weights]))(
        jnp.asarray(x)
    )
    xt = torch.from_numpy(x).requires_grad_()
    loss = _public_loss(tptwt, xt, mode, level, [torch.from_numpy(w) for w in weights])
    assert _used(model_kernels) == forward
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(loss, xt)
    _close(got, want, 1e-10)
    # every VJP is one launch of the other direction's kernel
    assert _used(model_kernels) == backward


@pytest.mark.parametrize("mode", [*PADDED, "valid"])
def test_k7_vjps_match_plain(model_kernels, mode):  # noqa: F811
    """K7a's VJP (one synthesis pyramid launch, folded, counted as K7b)
    and K7b's (one analysis pyramid launch, counted as K7a) against
    autograd through the plain versions, on a batch with two leading
    axes."""
    dl, dh, rl, rh = _banks("db3", np.float64)
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(2, 2, 65601)).requires_grad_()
    lo, hi = t7.flat_dwt_lane(x, dl, dh, mode)
    cts = [torch.from_numpy(rng.randn(*lo.shape)) for _ in range(2)]
    (got,) = torch.autograd.grad((lo, hi), x, cts)
    want = t2.dwt_axis_vjp_plain(x, -1, dl, dh, mode, torch.stack(cts))
    _close(got, want.numpy(), 1e-12)
    a, b = (t.detach().requires_grad_() for t in (lo, hi))
    rec = t7.flat_idwt_lane(a, b, rl, rh, 4, 5)
    ct = torch.from_numpy(rng.randn(*rec.shape))
    got = torch.autograd.grad(rec, (a, b), ct)
    want = t2.idwt_axis_vjp_plain(a, b, -1, rl, rh, 4, 5, "zero", ct)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-12)
    # two forward launches and two VJP launches, no per-axis K3/K4
    assert _used(model_kernels) == {"K7a": 2, "K7b": 2}


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_k8_vjps_match_plain(model_kernels, depth):  # noqa: F811
    """K8a's VJP (one synthesis pyramid launch, counted as K8b) and K8b's
    (one analysis pyramid launch, counted as K8a) against autograd through
    the plain versions, reflect, with waverec's crops."""
    dl, dh, rl, rh = _banks("sym4", np.float64)
    rng = np.random.RandomState(depth)
    x = torch.from_numpy(rng.randn(2, 70003)).requires_grad_()
    lo, his = t8.flat_wavedec_lane_multi(x, dl, dh, "reflect", depth)
    cts = [torch.from_numpy(rng.randn(*t.shape)) for t in (lo, *his)]
    (got,) = torch.autograd.grad((lo, *his), x, cts)
    with torch.enable_grad():
        z = x.detach().requires_grad_()
        ref_lo, ref_his = t8.multi_analysis_plain(z, dl, dh, "reflect", depth)
        (want,) = torch.autograd.grad((ref_lo, *ref_his), z, cts)
    _close(got, want.numpy(), 1e-11)
    assert _used(model_kernels) == {"K8a": 1, "K8b": 1}
    coeffs = [t.detach().requires_grad_() for t in (ref_lo, *ref_his[::-1])]
    pads = [(2 * len(dl) - 3) // 2] * depth
    lens = [x.shape[-1]] + [h.shape[-1] for h in ref_his[:-1]]
    rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
    ct = torch.from_numpy(rng.randn(*rec.shape))
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, coeffs, ct)
    with torch.enable_grad():
        leaves = [c.detach().requires_grad_() for c in coeffs]
        want = torch.autograd.grad(t8.multi_synthesis_plain(leaves, rl, rh, pads, lens), leaves, ct)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-11)
    assert _used(model_kernels) == {"K8a": 1}


def _grad_of_grad(run, x: torch.Tensor) -> torch.Tensor:
    """``d/dx`` of the squared gradient of the cubed outputs."""
    x = x.detach().requires_grad_()
    (grad,) = torch.autograd.grad((run(x) ** 3).sum(), x, create_graph=True)
    return torch.autograd.grad((grad**2).sum(), x)[0]


def test_filter_grad_and_double_backward_raise(model_kernels, monkeypatch):  # noqa: F811
    """The fused 1d kernels refuse a filter gradient (by design); a second
    backward through their VJPs runs and meets the plain path's."""
    dl, dh, rl, rh = _banks("db2", np.float64)
    x = torch.randn(1, 70001, dtype=torch.float64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t8.flat_wavedec_lane_multi(x, torch.tensor(dl, requires_grad=True), dh, "reflect", 2)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t6.fused_wavedec1d_per(x[:, :4096], torch.tensor(dl, requires_grad=True), dh, 3)
    for run, kernels in (
        (lambda t: t8.flat_wavedec_lane_multi(t, dl, dh, "reflect", 2)[0], {"K8a": 2, "K8b": 2}),
        (lambda t: t7.flat_dwt_lane(t, dl, dh, "zero")[1], {"K7a": 2, "K7b": 2}),
        (lambda t: t6.fused_wavedec1d_per(t[:, :4096], dl, dh, 3)[0], {"K6a": 2, "K6b": 2}),
    ):
        _kernels.reset_launch_counts()
        got = _grad_of_grad(run, x)
        # forward, its VJP, the VJP's VJP (the forward's kernel) and the
        # forward's VJP again
        assert _used(model_kernels) == kernels
        with monkeypatch.context() as plain:
            for module in (t6, t7, t8):
                plain.setattr(module, "_on_cpu", lambda t: True)
            want = _grad_of_grad(run, x)
        _close(got, want.numpy(), 1e-10 * float(want.abs().max()))
