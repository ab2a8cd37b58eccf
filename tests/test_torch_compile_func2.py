"""``torch.compile`` of second derivatives through the kernels' custom
ops: the port's counterpart of ``jax.jit(jax.grad(jax.grad(f)))``.

On the kernel model (``model_kernels``), float64: (b) ``torch.func.grad``
of the squared ``torch.func.grad`` of the cubic loss at every row of
``tests/test_torch_second_order.py`` (K1/K2, K3/K4, K5, K6, K7, K8, the
dense products, the O(n) long-axis ops), and through the fused
boundary-wavelet runs, whose backwards pull back through a nested
``torch.func.vjp``; (c) a learnable bank's pure and mixed hypergradients
(KT, then KT's VJP on K3/K4).  Each program compiled
(``fullgraph=True``, ``aot_eager``, one graph, no break) equals eager
``torch.func`` at 1e-12 with the same launches per kernel, and
``jax.jit`` of the JAX package's composition at the eager tests'
tolerance (1e-10 of the largest entry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_compile_func import check_compiled, close, compiled
from test_torch_kernels import model_kernels  # noqa: F401
from test_torch_matrix_long import SHORTEST, no_jax_runs  # noqa: F401
from test_torch_second_order import LEARN, ROWS, _cubic, _forward, _input, _learn_loss, _mixed, _pure
from test_torch_wavelets_learnable import _banks
from torch.utils._pytree import tree_leaves

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from _torch_one_thread import one_torch_thread  # noqa: F401


def _grad_of_grad(grad, loss, xp):
    """The gradient of the squared gradient of ``loss``."""
    return grad(lambda t: xp.sum(grad(loss)(t) ** 2))


@pytest.mark.parametrize("name", list(ROWS))
def test_compiled_grad_of_grad(model_kernels, name):  # noqa: F811
    """(b) ``torch.compile(torch.func.grad(|torch.func.grad(L)|^2))``."""
    x = _input(name)
    got, launches, _ = check_compiled(
        model_kernels, _grad_of_grad(torch.func.grad, _cubic(_forward(name, tptwt), torch), torch),
        torch.from_numpy(x),
    )
    assert ROWS[name][2] <= set(launches)
    want = jax.jit(_grad_of_grad(jax.grad, _cubic(_forward(name, jptwt), jnp), jnp))(jnp.asarray(x))
    close(got, want, 1e-10)


def _runs_loss(p, xp):
    """The cubed coefficients and reconstruction of two boundary-wavelet
    levels fused into one run (at :data:`SHORTEST`'s lengths)."""
    mwd, mwr = p.MatrixWavedec("db2", 2), p.MatrixWaverec("db2")

    def fn(z):
        coeffs = mwd(z)
        return sum(xp.sum(c**3) for c in [*coeffs, mwr(coeffs)])

    return fn


def test_compiled_long_runs_grad_of_grad(model_kernels, no_jax_runs):  # noqa: F811
    """(b) through the fused long runs (K8a/K8b's sameshift instances),
    whose backwards re-run their per-level chains under ``torch.func.vjp``:
    a transform level inside the compiled ``torch.func.grad``'s."""
    x = np.random.RandomState(9).randn(1, SHORTEST[2])
    got, launches, eager = check_compiled(
        model_kernels, _grad_of_grad(torch.func.grad, _runs_loss(tptwt, torch), torch), torch.from_numpy(x),
        same_launches=False,
    )
    # the pullbacks evaluate their chains at zero, which eager launches and
    # the compiled graph drops (no output of theirs is used): every kernel
    # the same or fewer times, the fused runs' as often
    assert set(launches) == set(eager) == {"K8a", "K8b", "K7a", "K7b", "K3", "K4"}
    assert all(launches[k] <= eager[k] for k in eager)
    assert [launches[k] for k in ("K8a", "K8b")] == [eager[k] for k in ("K8a", "K8b")]
    close(got, jax.jit(_grad_of_grad(jax.grad, _runs_loss(jptwt, jnp), jnp))(jnp.asarray(x)), 1e-10)


KINDS = {"pure": _pure, "mixed": _mixed}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(LEARN))
def test_compiled_learnable_second_derivatives(model_kernels, name, kind):  # noqa: F811
    """(c) a learnable bank's hypergradient: KT for the taps' gradient,
    K3/K4 for KT's VJP, compiled as eager."""
    bank, jbank = _banks("db2+")
    x = np.random.RandomState(11).randn(*LEARN[name][0])
    filters = [f.detach().clone() for f in bank.filter_bank]
    program = KINDS[kind](torch.func.grad, _learn_loss(name, tptwt, torch), torch.from_numpy(x))
    got, launches, _ = check_compiled(model_kernels, program, filters)
    assert set(launches) == {"K3", "K4", "KT"}
    want = jax.jit(KINDS[kind](jax.grad, _learn_loss(name, jptwt, jnp), jnp.asarray(x)))(tuple(jbank.filter_bank))
    close(got, [np.asarray(w) for w in want], 1e-10)


def test_compiled_grad_of_grad_keeps_no_traced_constant(model_kernels):  # noqa: F811
    """The compiled grad of grad runs the fused runs' pullbacks on a
    trace's fake tensors, which take their operators uncached: after it
    every operator the long ops and ``_matmul`` keep is a plain tensor
    (neither a fake or functional stand-in nor a ``torch.func`` wrapper),
    and eager calls through the same objects give the compiled result.
    The operators are built by a first eager call, as ``jax.jit`` of the
    matrix transforms takes a warm cache."""
    import gc

    from ptwt_tpu_torch.ops import _boundary_long, _matmul
    from ptwt_tpu_torch.ops._library import traced

    x = torch.from_numpy(np.random.RandomState(12).randn(1, SHORTEST[2]))
    program = _grad_of_grad(torch.func.grad, _runs_loss(tptwt, torch), torch)
    want = program(x)
    got = compiled(program)(x)
    kept = [t for obj in gc.get_objects() if issubclass(type(obj), _boundary_long._Constants)
            for t in obj._tensors.values()]
    kept += [t for cache in (_matmul._HOST, _matmul._DEVICE) for t in tree_leaves(list(cache._store.values()))
             if isinstance(t, torch.Tensor)]
    assert kept
    for t in kept:
        assert not traced(t) and not torch._C._functorch.is_functorch_wrapped_tensor(t)
    close(got, want)
    close(program(x), want)
