"""The kernels' custom ops under ``torch.compile``, ``torch.func.grad`` and
``torch.func.vmap``, on the CUDA glue run against the numpy model of the
kernels (``model_kernels`` of ``tests/test_torch_kernels.py``).

Each row of ``tests/_torch_transforms.py``, and rows that reach the other
kernels (K1/K2 in ``periodic``, K5, K6, K7/K8 on a long last axis, KT for
a learnable bank), is run eagerly and then compiled (``aot_eager``, one
graph): the same values and the same launches per kernel, as the ops
stay opaque in the graph.  ``torch.func.grad`` gives
``torch.autograd.grad``'s gradient with the same launches, and
``torch.func.vmap`` over a stack gives the batched call's values with the
batched call's launches (one launch a kernel, the vmapped dimension in
the kernels' batch axis).  Every op passes ``torch.library.opcheck`` on
arguments recorded from the glue.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_transforms import ROWS, roundtrip, row_input
from test_torch_kernels import model_kernels  # noqa: F401
from test_torch_wavelets_learnable import _banks
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.ops import _boundary_long, _kernels
from ptwt_tpu_torch.ops._library import NAMESPACE
from _torch_one_thread import one_torch_thread  # noqa: F401


def _conv_row(shape, fwd, inv):
    def make(p):
        return (lambda t: fwd(p, t)), (lambda c: inv(p, c))

    return shape, make


#: Rows that reach the kernels the rows of tests/test_jit.py do not.
KERNEL_ROWS = {
    "periodic2d": _conv_row(
        (2, 32, 32), lambda p, t: p.wavedec2(t, "db2", mode="periodic", level=2),
        lambda p, c: p.waverec2(c, "db2", mode="periodic")),
    "per2d": _conv_row(
        (2, 32, 32), lambda p, t: p.wavedec2(t, "db2", mode="periodization", level=2),
        lambda p, c: p.waverec2(c, "db2", mode="periodization")),
    "per1d": _conv_row(
        (2, 64), lambda p, t: p.wavedec(t, "db2", mode="periodization", level=3),
        lambda p, c: p.waverec(c, "db2", mode="periodization")),
    "long1d": _conv_row(
        (1, 70001), lambda p, t: p.wavedec(t, "db2", mode="reflect", level=2), lambda p, c: p.waverec(c, "db2")),
}
NAMES = list(ROWS) + list(KERNEL_ROWS)


def _row(name):
    """``(fn, x)``: the row's function of the port and its float64 input."""
    if name in ROWS:
        x = row_input(name).astype(np.float64)
        fwd, inv = ROWS[name][2](tptwt)
    else:
        shape, make = KERNEL_ROWS[name]
        x = np.random.RandomState(7).randn(*shape)
        fwd, inv = make(tptwt)
    if name.startswith("mat"):
        fwd(torch.from_numpy(x))
    return roundtrip(fwd, inv), torch.from_numpy(x)


def _run(launches, fn, *args):
    _kernels.reset_launch_counts()
    out = fn(*args)
    return out, dict(launches)


def _close(got, want, tol=1e-12):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_compiled_launches_match_eager(model_kernels, name):  # noqa: F811
    fn, x = _row(name)
    want, eager = _run(model_kernels, fn, x)
    torch._dynamo.reset()
    graph = torch.compile(fn, fullgraph=True, backend="aot_eager", dynamic=False)
    got, compiled = _run(model_kernels, graph, x)
    _close(got, want)
    assert compiled == eager


@pytest.mark.parametrize("name", NAMES)
def test_func_grad_launches_match_autograd(model_kernels, name):  # noqa: F811
    fn, x = _row(name)

    def loss(t):
        return (fn(t) ** 2).sum()

    got, functional = _run(model_kernels, torch.func.grad(loss), x)
    xr = x.clone().requires_grad_()
    (want,), eager = _run(model_kernels, lambda t: torch.autograd.grad(loss(t), t), xr)
    _close(got, want)
    assert functional == eager


@pytest.mark.parametrize("name", NAMES)
def test_func_vmap_launches_match_batched_call(model_kernels, name):  # noqa: F811
    fn, x = _row(name)
    xs = torch.stack([x, x.flip(-1), 2 * x])
    got, vmapped = _run(model_kernels, torch.func.vmap(fn), xs)
    flat, batched = _run(model_kernels, fn, xs.reshape(-1, *x.shape[1:]))
    if name == "cwt":  # [scales, batch, time]
        flat = flat.reshape(flat.shape[0], 3, -1, flat.shape[-1]).movedim(1, 0)
    _close(got, flat.reshape(got.shape))
    assert vmapped == batched


def test_learnable_step_launches(model_kernels):  # noqa: F811
    """A learnable bank's step (K3/K4 forward, KT and the VJPs backward):
    compiled and eager, and ``torch.func.grad`` and autograd, with the same
    values and launches."""
    bank, _ = _banks("db2+")
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 20, 18))

    def loss(filters, t):
        coeffs = tptwt.wavedec2(t, tuple(filters), mode="reflect", level=2)
        rec = tptwt.waverec2(coeffs, tuple(filters), mode="reflect")
        return sum((c**2).sum() for c in tree_leaves(coeffs)) + (rec * t).sum()

    params = [f.detach().clone().requires_grad_() for f in bank.filter_bank]
    want, eager = _run(model_kernels, lambda: torch.autograd.grad(loss(params, x), params))
    assert {k for k, v in eager.items() if v} == {"K3", "K4", "KT"}
    torch._dynamo.reset()
    graph = torch.compile(loss, fullgraph=True, backend="aot_eager", dynamic=False)
    got, compiled = _run(model_kernels, lambda: torch.autograd.grad(graph(params, x), params))
    _close(got, want)
    assert compiled == eager
    got, functional = _run(model_kernels, torch.func.grad(loss), [p.detach() for p in params], x)
    _close(got, want)
    assert functional == eager


# ---------------------------------------------------------------------------
# opcheck
# ---------------------------------------------------------------------------


class _Record(TorchDispatchMode):
    """The arguments of each of the port's ops at its first call."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == NAMESPACE and func not in self.calls:
            self.calls[func] = tree_map(lambda a: a.detach().clone() if isinstance(a, torch.Tensor) else a, args)
        return func(*args, **(kwargs or {}))


#: Ops whose formula is the paired op's; the others' VJPs have none.
_DIFFERENTIABLE = {
    "analysis_axis", "synthesis_axis", "dwt2_level", "idwt2_level", "wavedec1d_run", "waverec1d_run",
    "wavedec2d_run", "waverec2d_run", "lane_analysis", "lane_synthesis", "axis_matmul",
}


def _recorded_calls():
    bank, _ = _banks("db2+")
    learn = [f.detach().clone().requires_grad_() for f in bank.filter_bank]
    rows = [_row(name) for name in ("periodic2d", "per2d", "per1d", "long1d", "2d", "mat")]
    run = _boundary_long.LongAnalysisRun("db2", (2048, 1024))
    syn = _boundary_long.LongSynthesisRun("db2", (1024, 2048))
    record = _Record()
    with record:
        for fn, x in rows:
            xr = x.clone().requires_grad_()
            torch.autograd.grad((fn(xr) ** 2).sum(), xr)
        t = torch.randn(1, 20, 18, dtype=torch.float64)
        torch.autograd.grad(sum((c**2).sum() for c in tree_leaves(tptwt.wavedec2(t, tuple(learn), level=1))), learn[:2])
        xr = torch.randn(2, 2048, dtype=torch.float64, requires_grad=True)
        lo, his = run.apply(xr)
        torch.autograd.grad((lo**2).sum() + sum((h**2).sum() for h in his), xr)
        bands = [torch.randn(2, n, dtype=torch.float64, requires_grad=True) for n in (512, 512, 1024)]
        torch.autograd.grad((syn.apply(bands[0], bands[1:]) ** 2).sum(), bands)
    return record.calls


def test_opcheck_every_op(model_kernels):  # noqa: F811
    calls = _recorded_calls()
    names = {op.name() for op in calls}
    assert names == {f"{NAMESPACE}::{name}" for name in [*_DIFFERENTIABLE, "tap_grad", "lane_adjoint",
                                                          "long_analysis_run", "long_synthesis_run"]}
    for op, args in calls.items():
        if op.name().split("::")[1] in _DIFFERENTIABLE:
            args = tree_map(lambda a: a.requires_grad_() if isinstance(a, torch.Tensor) and a.is_floating_point()
                            and a.dim() > 1 else a, args)
        results = torch.library.opcheck(op, args)
        assert all(r == "SUCCESS" for r in results.values()), (op.name(), results)
