"""``torch.compile`` over ``torch.func`` through the kernels' custom ops:
the port's counterpart of ``jax.jit`` over ``jax.grad`` and ``jax.vmap``.

On the CUDA glue run against the numpy model of the kernels
(``model_kernels`` of ``tests/test_torch_kernels.py``), float64, each
program is run eagerly and then under ``torch.compile(fullgraph=True,
backend="aot_eager", dynamic=False)``: (a) ``torch.func.grad`` of the sum
of the squared outputs of every row of
``tests/test_torch_compile_kernels.py`` (K1-K8, KT-free), and (d)
``torch.func.vmap`` of ``torch.func.grad`` over a batch split into
samples (per-sample gradients).  Compiled equals eager at 1e-12 with the
same launches per kernel, in one graph with no break; one row per kernel
family also meets ``jax.jit`` of the same ``jax.grad`` composition of the
JAX package.  Grad of grad and a learnable bank's hypergradients are in
``tests/test_torch_compile_func2.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_transforms import ROWS, roundtrip
from test_torch_compile_kernels import KERNEL_ROWS, NAMES, _row
from test_torch_kernels import model_kernels  # noqa: F401
from torch._dynamo.utils import counters
from torch.utils._pytree import tree_leaves

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from _torch_one_thread import one_torch_thread  # noqa: F401


def run(launches, fn, *args):
    """``fn(*args)`` and the launches per kernel it made."""
    from ptwt_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    out = fn(*args)
    return out, {k: v for k, v in launches.items() if v}


def compiled(fn):
    """``fn`` under ``torch.compile(fullgraph=True, backend="aot_eager")``,
    with dynamo's counters cleared for :func:`assert_one_graph`."""
    torch._dynamo.reset()
    counters.clear()
    return torch.compile(fn, fullgraph=True, backend="aot_eager", dynamic=False)


def assert_one_graph() -> None:
    """No graph break, and one graph, since :func:`compiled`."""
    assert not counters["graph_break"], dict(counters["graph_break"])
    assert counters["stats"]["unique_graphs"] == 1


def close(got, want, tol=1e-12) -> None:
    """Every leaf within ``tol`` of the largest entry of ``want`` (at least 1)."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w.detach() if isinstance(w, torch.Tensor) else w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, atol=tol * max(1.0, float(np.abs(w).max())), rtol=0)


def check_compiled(launches, program, *args, same_launches=True):
    """``program`` eager and compiled: the same values (1e-12) and
    launches, one graph.  Returns the compiled values and launches, and
    eager's."""
    want, eager = run(launches, program, *args)
    got, graph = run(launches, compiled(program), *args)
    assert_one_graph()
    close(got, want)
    if same_launches:
        assert graph == eager
    return got, graph, eager


def _jax_fn(name):
    """The row's function of the JAX package (``_row``'s, for ``ptwt_tpu``)."""
    if name in ROWS:
        fwd, inv = ROWS[name][2](jptwt)
    else:
        fwd, inv = KERNEL_ROWS[name][1](jptwt)
    return roundtrip(fwd, inv)


#: one row per kernel family (K3/K4 and the dense product, K1/K2, K5, K6,
#: K7/K8 with K3/K4) that also meets jax.jit of the jax.grad composition
JAX_ROWS = ["2d", "mat", "periodic2d", "per2d", "per1d", "long1d"]


@pytest.mark.parametrize("name", NAMES)
def test_compiled_func_grad(model_kernels, name):  # noqa: F811
    """(a) ``torch.compile(torch.func.grad(loss))``."""
    fn, x = _row(name)

    def loss(t):
        return (fn(t) ** 2).sum()

    got, launches, _ = check_compiled(model_kernels, torch.func.grad(loss), x)
    assert launches or name not in KERNEL_ROWS
    if name in JAX_ROWS:
        jfn = _jax_fn(name)
        if name.startswith("mat"):  # the operators' cache, warmed before jax.jit
            jfn(jnp.asarray(x.numpy()))
        want = jax.jit(jax.grad(lambda t: jnp.sum(jfn(t) ** 2)))(jnp.asarray(x.numpy()))
        close(got, want, 1e-10)


#: rows of (d): a 2d row on K1/K2 and a 1d row on K6
VMAP_ROWS = ["periodic2d", "per1d"]


@pytest.mark.parametrize("name", VMAP_ROWS)
def test_compiled_vmap_of_grad(model_kernels, name):  # noqa: F811
    """(d) ``torch.func.vmap(torch.func.grad(loss))`` over the batch split
    into samples of one: per-sample gradients, each kernel launched once a
    level for the whole batch, as eager ``torch.func`` launches it."""
    fn, x = _row(name)

    def loss(t):
        return sum((c**3).sum() for c in tree_leaves(fn(t)))

    samples = x.unsqueeze(1)
    got, launches, _ = check_compiled(model_kernels, torch.func.vmap(torch.func.grad(loss)), samples)
    assert launches
    jfn = _jax_fn(name)
    want = jax.jit(jax.vmap(jax.grad(lambda t: sum(jnp.sum(c**3) for c in jax.tree_util.tree_leaves(jfn(t))))))(
        jnp.asarray(samples.numpy())
    )
    close(got, want, 1e-10)


# ---------------------------------------------------------------------------
# a bank of tensors that no level differentiates
# ---------------------------------------------------------------------------


#: where a filter tensor ``w`` enters a ``torch.func`` program of ``probe(x,
#: w)``, and whether a level differentiates it: closed over under vmap alone
#: or under grad with respect to the data, an argument that grad wraps, the
#: differentiated argument, an outer level's inside an inner grad
TRACKED = {
    "vmap, closed over": (False, lambda f, w: torch.func.vmap(lambda t: f(t, w))),
    "vmap of grad, closed over": (False, lambda f, w: torch.func.vmap(torch.func.grad(lambda t: f(t, w)))),
    "grad of x, closed over": (False, lambda f, w: torch.func.grad(lambda t: f(t, w))),
    "grad of grad of x, closed over": (
        False, lambda f, w: torch.func.grad(lambda t: (torch.func.grad(lambda u: f(u, w))(t) ** 2).sum())),
    "grad of x, argument": (True, lambda f, w: lambda t: torch.func.grad(f)(t, w)),
    "grad of w": (True, lambda f, w: lambda t: torch.func.grad(f, argnums=1)(t, w)),
    "outer level's w": (
        True, lambda f, w: lambda t: torch.func.grad(lambda v: (torch.func.grad(lambda u: f(u, v))(t) ** 2).sum())(w)),
}


@pytest.mark.parametrize("case", list(TRACKED))
def test_grad_tracked_compiled(case):
    """``grad_tracked`` under dynamo answers per tensor as it does eagerly:
    a vmap level, or a grad level that did not wrap the tensor, leaves it
    constant, so the compiled program routes a bank as eager
    ``torch.func`` does."""
    from ptwt_tpu_torch.ops import _kernels

    want, make = TRACKED[case]
    seen = []

    def probe(t, w):
        seen.append(_kernels.grad_tracked(w))
        return (t * w).sum()

    w = torch.linspace(-1.0, 1.0, 4, dtype=torch.float64)
    x = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    program = make(probe, w)
    eager = program(x)
    assert seen == [want]
    seen.clear()
    close(compiled(program)(x), eager)
    assert_one_graph()
    assert seen == [want]


def _tensor_bank():
    """db2 as a bank of detached float64 tensors."""
    from ptwt_tpu_torch.constants import WaveletTensorTuple
    from ptwt_tpu_torch.wavelets import Wavelet

    return WaveletTensorTuple(*(torch.tensor(f, dtype=torch.float64) for f in Wavelet("db2").filter_bank))


#: programs over a closed-over constant bank, vmap alone and grad with
#: respect to the data only, and the kernels eager ``torch.func`` launches
#: for their periodic 2d round trip: the fused K1/K2 under vmap; under grad
#: the bank's flipped copy is made at the grad level, which wraps it, so
#: eager runs per axis as well
BANK_PROGRAMS = {
    "vmap": (torch.func.vmap, {"K1", "K2", "K3", "K4"}),
    "grad of x": (torch.func.grad, {"K3", "K4"}),
}


@pytest.mark.parametrize("program", list(BANK_PROGRAMS))
def test_compiled_constant_tensor_bank(model_kernels, program):  # noqa: F811
    """A periodic 2d round trip over a bank of detached tensors.  No level
    differentiates the bank, so neither program launches KT.  While dynamo
    traces, a tensor's values are unknown and the fused kernels take their
    taps as launch constants, so the compiled program runs every axis on
    K3/K4 (``filters_traced``), in one graph, with eager's values."""
    bank = _tensor_bank()

    def loss(t):
        coeffs = tptwt.wavedec2(t, bank, mode="periodic", level=2)
        return sum((c**2).sum() for c in tree_leaves((coeffs, tptwt.waverec2(coeffs, bank, mode="periodic"))))

    transform, eager_kernels = BANK_PROGRAMS[program]
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 32, 32))
    _, graph, eager = check_compiled(model_kernels, transform(loss), x, same_launches=False)
    assert set(eager) == eager_kernels
    assert set(graph) == {"K3", "K4"}


@pytest.mark.parametrize("program", list(BANK_PROGRAMS))
def test_compiled_matrix_tensor_bank(model_kernels, program):  # noqa: F811
    """A matrix round trip over a bank of detached tensors, its operators
    built by an eager call (they are built on the host, which a trace
    cannot do), then compiled: eager's values and launches."""
    bank = _tensor_bank()
    mwd, mwr = tptwt.MatrixWavedec(bank, 3), tptwt.MatrixWaverec(bank)
    x = torch.from_numpy(np.random.RandomState(7).randn(4, 64))
    mwr(mwd(x))

    def loss(t):
        coeffs = mwd(t)
        return sum((c**2).sum() for c in tree_leaves((coeffs, mwr(coeffs))))

    check_compiled(model_kernels, BANK_PROGRAMS[program][0](loss), x)
