"""``torch.func.grad`` and ``torch.func.vmap`` of every transform of
``tests/test_jit.py`` against ``jax.grad`` and ``jax.vmap``.

Every row of ``tests/_torch_transforms.py`` in float64: the gradient of
the sum of its coefficients' squares plus its round trip weighted by a
fixed draw, by ``torch.func.grad`` against ``jax.grad`` (1e-10 of the
largest entry) and against ``torch.autograd.grad``; ``torch.func.vmap``
over three stacked inputs against ``jax.vmap`` and against the batched
call, the stack folded into the leading batch axis.  Then the two
``tests/test_jit.py`` tests of grad and vmap, and a learnable bank's
step.  The repros of the two faults this covers: a numpy dtype read from
a tensor that ``torch.func`` leaves without storage, and a Function
``torch.func`` refused (the matrix products).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_transforms import ROWS, roundtrip, row_input
from test_torch_wavelets_learnable import _banks
from torch.utils._pytree import tree_leaves

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from _torch_one_thread import one_torch_thread  # noqa: F401


def _loss(fwd, inv, weight, total, leaves):
    """Sum of the coefficients' squares plus the weighted round trip."""

    def loss(t):
        coeffs = fwd(t)
        out = total(c**2 for c in leaves(coeffs))
        if inv is not None:
            out = out + (inv(coeffs) * weight).sum()
        return out

    return loss


def _both(name):
    make = ROWS[name][2]
    jfwd, jinv = make(jptwt)
    tfwd, tinv = make(tptwt)
    x = row_input(name).astype(np.float64)
    out = roundtrip(tfwd, tinv)(torch.from_numpy(x))
    weight = np.random.RandomState(8).randn(*out.shape)
    jloss = _loss(jfwd, jinv, jnp.asarray(weight), lambda cs: sum(jnp.sum(c) for c in cs), jax.tree_util.tree_leaves)
    tloss = _loss(tfwd, tinv, torch.from_numpy(weight), lambda cs: sum(c.sum() for c in cs), tree_leaves)
    return x, jloss, tloss


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=rel * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("name", list(ROWS))
def test_func_grad_matches_jax_grad(name):
    x, jloss, tloss = _both(name)
    want = jax.grad(jloss)(jnp.asarray(x))
    got = torch.func.grad(tloss)(torch.from_numpy(x))
    _close(got, want, 1e-10)
    xr = torch.from_numpy(x).requires_grad_()
    (eager,) = torch.autograd.grad(tloss(xr), xr)
    _close(got, eager, 1e-12)


@pytest.mark.parametrize("name", list(ROWS))
def test_func_vmap_matches_jax_vmap(name):
    xs = row_input(name, batch=3)
    tol = ROWS[name][3]
    make = ROWS[name][2]
    jfn, tfn = roundtrip(*make(jptwt)), roundtrip(*make(tptwt))
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(xs)))
    got = torch.func.vmap(tfn)(torch.from_numpy(xs))
    # float32 (cwt): the port's float32 contract with JAX, as in
    # tests/test_torch_compile.py
    _close(got, want, tol if xs.dtype == np.float64 else 1e-5)
    # the batched call: the stack folded into the leading batch axis
    flat = tfn(torch.from_numpy(xs.reshape(-1, *xs.shape[2:])))
    if name == "cwt":  # [scales, batch, time]
        batched = flat.reshape(flat.shape[0], 3, -1, flat.shape[-1]).movedim(1, 0)
    else:
        batched = flat.reshape(3, -1, *flat.shape[1:])
    _close(got, batched, 1e-12)


def test_grad_through_all_primitive_transforms():
    """``tests/test_jit.py``'s gradient test: 1d, 2d and swt losses."""
    rng = np.random.RandomState(7)
    cases = [
        (rng.randn(33), lambda p, t: p.wavedec(t, "db2", level=2)),
        (rng.randn(16, 16), lambda p, t: p.wavedec2(t, "haar", level=2)),
        (rng.randn(32), lambda p, t: p.swt(t, "db2", level=2)),
    ]
    for x, fwd in cases:
        want = jax.grad(lambda t: sum(jnp.sum(c**2) for c in jax.tree_util.tree_leaves(fwd(jptwt, t))))(jnp.asarray(x))
        got = torch.func.grad(lambda t: sum((c**2).sum() for c in tree_leaves(fwd(tptwt, t))))(torch.from_numpy(x))
        assert bool(torch.isfinite(got).all())
        _close(got, want, 1e-10)


def test_vmap_over_transforms():
    """``tests/test_jit.py``'s vmap test."""
    rng = np.random.RandomState(7)
    xs = rng.randn(5, 2, 64)
    want = jax.vmap(lambda t: jptwt.wavedec(t, "db2", level=2))(jnp.asarray(xs))
    got = torch.func.vmap(lambda t: tptwt.wavedec(t, "db2", level=2))(torch.from_numpy(xs))
    ref = tptwt.wavedec(torch.from_numpy(xs.reshape(10, 64)), "db2", level=2)
    for g, w, r in zip(got, want, ref):
        _close(g, w, 1e-12)
        _close(g.reshape(10, -1), r, 1e-12)
    x2 = rng.randn(4, 16, 16)
    vrec = torch.func.vmap(lambda t: tptwt.waverec2(tptwt.wavedec2(t, "db2", level=1), "db2"))(torch.from_numpy(x2))
    _close(vrec, x2, 1e-12)


def test_learnable_step_grad_and_vmap():
    """A learnable bank's step: ``torch.func.grad`` with respect to the
    filters against ``jax.grad`` and ``torch.autograd.grad``; the forward
    vmapped over the data against the batched call."""
    bank, jbank = _banks("db2+")
    x = np.random.RandomState(7).randn(2, 20, 18)

    def tloss(filters, t):
        coeffs = tptwt.wavedec2(t, tuple(filters), mode="reflect", level=2)
        return sum((c**2).sum() for c in tree_leaves(coeffs))

    def jloss(filters, t):
        coeffs = jptwt.wavedec2(t, tuple(filters), mode="reflect", level=2)
        return sum(jnp.sum(c**2) for c in jax.tree_util.tree_leaves(coeffs))

    filters = [f.detach() for f in bank.filter_bank]
    got = torch.func.grad(tloss)(filters, torch.from_numpy(x))
    want = jax.grad(jloss)(list(jbank.filter_bank), jnp.asarray(x))
    params = [f.clone().requires_grad_() for f in filters]
    eager = torch.autograd.grad(tloss(params, torch.from_numpy(x)), params, allow_unused=True)
    eager = [torch.zeros_like(p) if e is None else e for p, e in zip(params, eager)]  # the rec filters
    for g, w, e in zip(got, want, eager):
        _close(g, w, 1e-10)
        _close(g, e, 1e-12)
    xs = torch.from_numpy(np.random.RandomState(9).randn(3, 2, 20, 18))
    fwd = lambda t: tptwt.wavedec2(t, tuple(params), mode="reflect", level=2)[0]  # noqa: E731
    got = torch.func.vmap(fwd)(xs)
    _close(got, fwd(xs.reshape(6, 20, 18)).detach().reshape(3, 2, *got.shape[-2:]), 1e-12)


def test_constants_made_under_a_transform_serve_later_calls():
    """Operators and plans first built while ``torch.func.grad`` runs are
    kept without the transform's wrapper, so later eager calls use them."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 48))
    mwd, mwr = tptwt.MatrixWavedec("sym3", level=2), tptwt.MatrixWaverec("sym3")

    def loss(t):
        return (mwr(mwd(t)) ** 2).sum() + (tptwt.cwt(t, [1.0, 2.5, 4.0], "morl")[0] ** 2).sum()

    got = torch.func.grad(loss)(x)
    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(loss(xr), xr)
    _close(got, want, 1e-12)
