"""Second derivatives through the kernels' custom ops.

Under eager autograd an op's backward is differentiable once, as each
kernel's ``once_differentiable`` Function was: a second backward raises.
Under ``torch.func`` the ops' formulas compose, so a gradient of a
gradient runs the paired ops in turn (K1 <-> K2, K3 <-> K4, K5a <-> K5b,
K6a <-> K6b, the dense products' transposes) and meets ``jax.grad`` of
``jax.grad`` of the JAX package; it raises at a VJP op that has no
formula of its own (KT, the lane kernels' adjoint).  The glue runs on the
numpy model of the kernels (``model_kernels``), in float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401
from test_torch_wavelets_learnable import _banks
from torch.utils._pytree import tree_leaves

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.ops import _kernels
from _torch_one_thread import one_torch_thread  # noqa: F401

#: name -> (input shape, forward transform of package p, kernels it reaches)
ROWS = {
    "periodic2d": ((2, 32, 32), lambda p, t: p.wavedec2(t, "db2", mode="periodic", level=2), {"K1", "K2"}),
    "reflect2d": ((2, 37, 52), lambda p, t: p.wavedec2(t, "db2", mode="reflect", level=2), {"K3", "K4"}),
    "per2d": ((2, 32, 32), lambda p, t: p.wavedec2(t, "db2", mode="periodization", level=2), {"K5a", "K5b"}),
    "per1d": ((2, 64), lambda p, t: p.wavedec(t, "db2", mode="periodization", level=3), {"K6a", "K6b"}),
    "mat": ((4, 64), None, set()),
}


def _forward(name, p):
    if name == "mat":
        mwd = p.MatrixWavedec("db2", level=3)
        return lambda t: mwd(t)
    return lambda t: ROWS[name][1](p, t)


def _cubic(fwd, xp):
    """A loss whose second derivative depends on ``x``: the sum of the
    cubed coefficients."""
    return lambda t: sum(xp.sum(c**3) for c in tree_leaves(fwd(t)))


def _input(name):
    return np.random.RandomState(7).randn(*ROWS[name][0])


@pytest.mark.parametrize("name", list(ROWS))
def test_autograd_second_backward_raises(model_kernels, name):  # noqa: F811
    x = torch.from_numpy(_input(name)).requires_grad_()
    loss = _cubic(_forward(name, tptwt), torch)
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(loss(x), x, create_graph=True)
    assert ROWS[name][2] <= {k for k, v in model_kernels.items() if v}
    with pytest.raises(RuntimeError, match="second backward through a kernel's VJP is not ported"):
        (grad**2).sum().backward()  # traverses the whole graph, the VJP's node too


@pytest.mark.parametrize("name", list(ROWS))
def test_func_grad_of_grad_matches_jax(model_kernels, name):  # noqa: F811
    x = _input(name)
    tloss = _cubic(_forward(name, tptwt), torch)
    jloss = _cubic(_forward(name, jptwt), jnp)
    _kernels.reset_launch_counts()
    got = torch.func.grad(lambda t: (torch.func.grad(tloss)(t) ** 2).sum())(torch.from_numpy(x))
    assert ROWS[name][2] <= {k for k, v in model_kernels.items() if v}
    want = jax.grad(lambda t: jnp.sum(jax.grad(jloss)(t) ** 2))(jnp.asarray(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10 * max(1.0, float(np.abs(want).max())), rtol=0)


def test_func_second_order_raises_at_the_tap_gradient(model_kernels):  # noqa: F811
    """A learnable bank's filter gradient is KT, whose own VJP is not
    ported: its second derivative raises under ``torch.func``."""
    bank, _ = _banks("db2+")
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 20, 18))

    def loss(filters):
        return sum((c**3).sum() for c in tree_leaves(tptwt.wavedec2(x, tuple(filters), mode="reflect", level=2)))

    filters = [f.detach().clone() for f in bank.filter_bank]
    torch.func.grad(loss)(filters)
    with pytest.raises(NotImplementedError, match="tap_grad is not ported"):
        torch.func.grad(lambda fs: sum((g**2).sum() for g in torch.func.grad(loss)(fs)))(filters)
