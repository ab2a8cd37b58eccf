"""Second derivatives through the kernels' custom ops.

Every op's backward is a formula of ops that have formulas of their own
(K1 <-> K2, K3 <-> K4, K5a <-> K5b, K6a <-> K6b, K7/K8 and their VJPs,
the dense products' transposes, KT and its VJP on K3/K4), so a gradient
of a gradient runs under eager autograd (``create_graph=True``) and under
``torch.func.grad`` of ``torch.func.grad``, and meets ``jax.grad`` of
``jax.grad`` of the JAX package: for the data, and for a learnable bank's
filters (pure and mixed).  ``gradgradcheck`` holds each K3/K4/KT op's
second derivatives against finite differences.  The glue runs on the
numpy model of the kernels (``model_kernels``), in float64.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401
from test_torch_matrix_long import SHORTEST, no_jax_runs  # noqa: F401
from test_torch_wavelets_learnable import _banks
from torch.utils._pytree import tree_leaves

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas2 as t2
from _torch_one_thread import one_torch_thread  # noqa: F401


def _round_trip_1d(p, t, level):
    """A long lane's coefficients and its reconstruction: K7/K8, both
    directions, and every lane op's VJP."""
    coeffs = p.wavedec(t, "db2", mode="reflect", level=level)
    return coeffs, p.waverec(coeffs, "db2")


#: name -> (input shape, forward transform of package p, kernels it reaches)
ROWS = {
    "periodic2d": ((2, 32, 32), lambda p, t: p.wavedec2(t, "db2", mode="periodic", level=2), {"K1", "K2"}),
    "reflect2d": ((2, 37, 52), lambda p, t: p.wavedec2(t, "db2", mode="reflect", level=2), {"K3", "K4"}),
    "per2d": ((2, 32, 32), lambda p, t: p.wavedec2(t, "db2", mode="periodization", level=2), {"K5a", "K5b"}),
    "per1d": ((2, 64), lambda p, t: p.wavedec(t, "db2", mode="periodization", level=3), {"K6a", "K6b"}),
    "mat": ((4, 64), None, set()),
    "lane4": ((2, 70001), lambda p, t: _round_trip_1d(p, t, 4), {"K8a", "K8b"}),
    "lane1": ((2, 70001), lambda p, t: _round_trip_1d(p, t, 1), {"K7a", "K7b"}),
    # past the 2048-sample cutoff: the O(n) boundary ops, K3/K4 interiors
    "long": ((2, 5000), None, {"K3", "K4"}),
}


def _forward(name, p):
    if name == "mat":
        mwd = p.MatrixWavedec("db2", level=3)
        return lambda t: mwd(t)
    if name == "long":
        mwd, mwr = p.MatrixWavedec("db3", level=3), p.MatrixWaverec("db3")

        def fwd(t):
            coeffs = mwd(t)
            return coeffs, mwr(coeffs)

        return fwd
    return lambda t: ROWS[name][1](p, t)


def _cubic(fwd, xp):
    """A loss whose second derivative depends on ``x``: the sum of the
    cubed coefficients."""
    return lambda t: sum(xp.sum(c**3) for c in tree_leaves(fwd(t)))


def _input(name):
    return np.random.RandomState(7).randn(*ROWS[name][0])


@functools.lru_cache(maxsize=None)
def _jax_grad_of_grad(name) -> np.ndarray:
    """``jax.grad`` of the squared gradient of the cubic loss."""
    jloss = _cubic(_forward(name, jptwt), jnp)
    return np.asarray(jax.grad(lambda t: jnp.sum(jax.grad(jloss)(t) ** 2))(jnp.asarray(_input(name))))


def _close(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, atol=1e-10 * max(1.0, float(np.abs(want).max())), rtol=0
    )


def _reached(launches) -> set:
    return {k for k, v in launches.items() if v}


@pytest.mark.parametrize("name", list(ROWS))
def test_autograd_grad_of_grad_matches_jax(model_kernels, name):  # noqa: F811
    """Eager autograd: the first backward with ``create_graph=True``
    records the paired ops, whose formulas the second backward runs."""
    x = torch.from_numpy(_input(name)).requires_grad_()
    loss = _cubic(_forward(name, tptwt), torch)
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(loss(x), x, create_graph=True)
    (got,) = torch.autograd.grad((grad**2).sum(), x)
    assert ROWS[name][2] <= _reached(model_kernels)
    _close(got, _jax_grad_of_grad(name))


@pytest.mark.parametrize("name", list(ROWS))
def test_func_grad_of_grad_matches_jax(model_kernels, name):  # noqa: F811
    tloss = _cubic(_forward(name, tptwt), torch)
    _kernels.reset_launch_counts()
    got = torch.func.grad(lambda t: (torch.func.grad(tloss)(t) ** 2).sum())(torch.from_numpy(_input(name)))
    assert ROWS[name][2] <= _reached(model_kernels)
    _close(got, _jax_grad_of_grad(name))


@pytest.mark.parametrize("path", ["autograd", "func"])
def test_long_runs_grad_of_grad_match_jax(model_kernels, no_jax_runs, path):  # noqa: F811
    """The fused boundary-wavelet runs (K8a/K8b's sameshift instances) pull
    back through ``torch.func.vjp`` of their per-level chains, whose result
    carries the graph: a second backward runs the chains' ops again (the
    level past ``2**16`` on K7, the other on K3/K4)."""
    x = np.random.RandomState(9).randn(1, SHORTEST[2])

    def loss(p, xp):
        def fn(z):
            coeffs = p.MatrixWavedec("db2", 2)(z)
            return sum(xp.sum(c**3) for c in [*coeffs, p.MatrixWaverec("db2")(coeffs)])

        return fn

    want = jax.jit(jax.grad(lambda z: jnp.sum(jax.grad(loss(jptwt, jnp))(z) ** 2)))(jnp.asarray(x))
    tloss = loss(tptwt, torch)
    _kernels.reset_launch_counts()
    if path == "func":
        got = torch.func.grad(lambda t: (torch.func.grad(tloss)(t) ** 2).sum())(torch.from_numpy(x))
    else:
        xt = torch.from_numpy(x).requires_grad_()
        (grad,) = torch.autograd.grad(tloss(xt), xt, create_graph=True)
        (got,) = torch.autograd.grad((grad**2).sum(), xt)
    assert {"K8a", "K8b", "K7a", "K7b", "K3", "K4"} <= _reached(model_kernels)
    _close(got, want)


# ---------------------------------------------------------------------------
# a learnable bank: the taps' second derivatives (KT's VJP, the fold's KT)
# ---------------------------------------------------------------------------

#: name -> (input shape, transform and inverse of package p with the bank's
#: filters ``fs``)
LEARN = {
    "2d reflect": ((1, 20, 18), "wavedec2", "waverec2", "reflect"),
    "2d periodic": ((1, 20, 18), "wavedec2", "waverec2", "periodic"),
    "1d reflect": ((2, 40), "wavedec", "waverec", "reflect"),
}


def _learn_loss(name, p, xp):
    """The cubic loss of the coefficients and the reconstruction, as a
    function of the four filters and the data."""
    _, fwd, inv, mode = LEARN[name]

    def loss(fs, t):
        coeffs = getattr(p, fwd)(t, tuple(fs), mode=mode, level=2)
        return sum(xp.sum(c**3) for c in tree_leaves((coeffs, getattr(p, inv)(coeffs, tuple(fs), mode=mode))))

    return loss


def _pure(grad, loss, x):
    """``d/dfilters`` of the filters' squared gradient: ``H_ff g_f``."""
    return grad(lambda fs: sum((g**2).sum() for g in grad(loss)(fs, x)))


def _mixed(grad, loss, x):
    """``d/dfilters`` of the data's squared gradient: the mixed term."""
    return grad(lambda fs: (grad(loss, argnums=1)(fs, x) ** 2).sum())


@functools.lru_cache(maxsize=None)
def _jax_learn(name, kind) -> list:
    _, jbank = _banks("db2+")
    x = jnp.asarray(np.random.RandomState(11).randn(*LEARN[name][0]))
    fn = _pure if kind == "pure" else _mixed
    jloss = _learn_loss(name, jptwt, jnp)
    return [np.asarray(g) for g in fn(jax.grad, jloss, x)(tuple(jbank.filter_bank))]


def _autograd_pure(loss, x):
    def run(fs):
        fs = [f.detach().requires_grad_() for f in fs]
        gs = torch.autograd.grad(loss(fs, x), fs, create_graph=True)
        return torch.autograd.grad(sum((g**2).sum() for g in gs), fs)

    return run


def _autograd_mixed(loss, x):
    def run(fs):
        fs = [f.detach().requires_grad_() for f in fs]
        xr = x.detach().requires_grad_()
        (gx,) = torch.autograd.grad(loss(fs, xr), xr, create_graph=True)
        return torch.autograd.grad((gx**2).sum(), fs)

    return run


RUNNERS = {
    ("autograd", "pure"): _autograd_pure,
    ("autograd", "mixed"): _autograd_mixed,
    ("func", "pure"): lambda loss, x: _pure(torch.func.grad, loss, x),
    ("func", "mixed"): lambda loss, x: _mixed(torch.func.grad, loss, x),
}


@pytest.mark.parametrize("path", ["autograd", "func"])
@pytest.mark.parametrize("kind", ["pure", "mixed"])
@pytest.mark.parametrize("name", list(LEARN))
def test_learnable_second_derivatives_match_jax(model_kernels, name, kind, path):  # noqa: F811
    """A learnable bank's hypergradients against ``jax.grad`` of
    ``jax.grad`` of ``ptwt_tpu``'s traced bank: K3/K4 carry every level,
    KT the taps' gradients and K3/K4 KT's VJP."""
    bank, _ = _banks("db2+")
    x = torch.from_numpy(np.random.RandomState(11).randn(*LEARN[name][0]))
    filters = [f.detach().clone() for f in bank.filter_bank]
    _kernels.reset_launch_counts()
    got = RUNNERS[path, kind](_learn_loss(name, tptwt, torch), x)(filters)
    assert _reached(model_kernels) == {"K3", "K4", "KT"}
    want = _jax_learn(name, kind)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-10 * scale, rtol=0)


# ---------------------------------------------------------------------------
# gradgradcheck of the K3/K4/KT ops on the kernel model
# ---------------------------------------------------------------------------

GG_N, GG_TAPS, GG_AX = 9, 4, 1
GG_MODES = ["zero", "reflect", "periodic", "periodization"]


def _gg_rand(*shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)).requires_grad_()


def _gg_k4_geometry(m: int, mode: str):
    """``(out_len, off, circular)`` of the public synthesis of ``m`` bands."""
    if mode == "periodization":
        return 2 * m, GG_TAPS // 2 - 1, True
    off = (2 * GG_TAPS - 3) // 2
    return 2 * (m - 1) + GG_TAPS - 2 * off, off, False


def _gg_case(kind: str, mode: str):
    """The function and inputs of one ``gradgradcheck`` case: an op with
    every tensor argument differentiable, filters included."""
    m, period, pad, code = t2._analysis_plan(GG_N, GG_TAPS, mode)
    taps = [_gg_rand(GG_TAPS, seed=s) for s in (1, 2)]
    if kind == "analysis":  # K3
        return (lambda x, lo, hi: t2.analysis_axis(x, lo, hi, None, None, GG_AX, m, period, pad, code),
                (_gg_rand(2, GG_N, 3, seed=0), *taps))
    if kind == "synthesis":  # K4, two pairs
        out_len, off, circular = _gg_k4_geometry(m, mode)

        def syn(a, b, c, d, lo, hi):
            return t2.synthesis_axis([a, c], [b, d], lo, hi, None, None, GG_AX, out_len, off, circular, 0, 0)

        return syn, (*(_gg_rand(2, m, 3, seed=s) for s in (3, 4, 5, 6)), *taps)
    if kind == "fold":  # K3's VJP: K4's fold instance (the plain one for zero)
        return (lambda a, b, lo, hi: t2.synthesis_axis([a], [b], lo, hi, None, None, GG_AX, GG_N, pad, False,
                                                       code, period),
                (*(_gg_rand(2, m, 3, seed=s) for s in (3, 4)), *taps))
    if kind == "tap_grad k3":  # KT on K3's taps
        return (lambda x, a, b: t2.tap_grad(x, [a], [b], GG_AX, GG_TAPS, period, pad, code),
                (_gg_rand(2, GG_N, 3, seed=0), *(_gg_rand(2, m, 3, seed=s) for s in (3, 4))))
    # KT on K4's taps: the [G, ...] output cotangent, two pairs, the geometry
    # of K4's VJP (zero-bounded, or modulo 2m for periodization)
    out_len, off, circular = _gg_k4_geometry(m, mode)
    period, code = (2 * m, t2._WRAP_ZERO) if circular else (out_len, t2._ZERO)

    def taps_k4(ext, a, b, c, d):
        return t2.tap_grad(ext, [a, c], [b, d], GG_AX + 1, GG_TAPS, period, off, code)

    return taps_k4, (_gg_rand(2, 2, out_len, 3, seed=0), *(_gg_rand(2, m, 3, seed=s) for s in (3, 4, 5, 6)))


@pytest.mark.parametrize("mode", GG_MODES)
@pytest.mark.parametrize("kind", ["analysis", "synthesis", "fold", "tap_grad k3", "tap_grad k4"])
def test_ops_gradgradcheck(model_kernels, kind, mode):  # noqa: F811
    fn, inputs = _gg_case(kind, mode)
    assert torch.autograd.gradgradcheck(fn, inputs)
    # the second derivatives run KT for the taps and K3/K4 for KT's VJP
    assert {"K3", "K4", "KT"} <= _reached(model_kernels)
