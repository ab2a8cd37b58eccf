"""``torch.compile`` of every transform of ``tests/test_jit.py`` against ``jax.jit``.

The port's counterpart of ``jax.jit`` is ``torch.compile(fullgraph=True)``:
the whole transform one graph, its host work (filter banks, plans, the
``cwt`` resampling plan, the axis permutations) constants of the program
as the JAX package's numpy work is of a ``jax.jit`` trace.  Each row of
``tests/_torch_transforms.py`` (one case of ``tests/test_jit.py``: its
inputs from its seed, its tolerance) is compiled with the ``aot_eager``
backend (no C++ build), held against eager at that tolerance (the JAX
test's own check: the compiled program against the uncompiled), against
``jax.jit`` of the JAX package, and traced by ``torch._dynamo.explain``
with no graph break.  Against ``jax.jit`` the float64 rows hold the JAX
test's tolerance; ``cwt`` in float32 holds the port's float32 contract
with JAX (``tests/test_torch_cwt.py``: 1e-5 of ``max(1, |coef|)``), since
two FFT libraries' float32 roundings differ by more than 1e-6 (5.0e-6 on
this input).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_transforms import ROWS, roundtrip, row_input

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.wavelets import Wavelet
from _torch_one_thread import one_torch_thread  # noqa: F401


def compiled(fn):
    """``fn`` compiled as one graph (static shapes; no C++ build)."""
    return torch.compile(fn, fullgraph=True, backend="aot_eager", dynamic=False)


def _functions(name):
    """The row's function for both packages (matrix operators built first,
    as ``tests/test_jit.py`` builds them before ``jax.jit``)."""
    x = row_input(name)
    make = ROWS[name][2]
    jfwd, jinv = make(jptwt)
    tfwd, tinv = make(tptwt)
    if name.startswith("mat"):
        jfwd(jnp.asarray(x))
        tfwd(torch.from_numpy(x))
    return roundtrip(jfwd, jinv), roundtrip(tfwd, tinv)


@pytest.mark.parametrize("name", list(ROWS))
def test_compile_matches_jax_jit(name):
    x = row_input(name)
    tol = ROWS[name][3]
    jfn, tfn = _functions(name)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    torch._dynamo.reset()
    explained = torch._dynamo.explain(tfn)(torch.from_numpy(x))
    assert explained.graph_break_count == 0, [b.reason for b in explained.break_reasons]
    assert explained.graph_count == 1
    torch._dynamo.reset()
    got = compiled(tfn)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), tfn(torch.from_numpy(x)).numpy(), atol=tol, rtol=0)
    assert got.shape == want.shape
    if x.dtype == np.float32:
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_compiled_step_matches_eager():
    """A training step compiled as one graph: the loss and the gradient of
    a compiled forward equal eager's (the ops' registered autograd)."""
    x = torch.from_numpy(row_input("2d"))

    def loss(t):
        coeffs = tptwt.wavedec2(t, "db2", mode="reflect", level=2)
        return coeffs[0].square().sum() + sum(d.square().sum() for tup in coeffs[1:] for d in tup)

    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(loss(xr), xr)
    torch._dynamo.reset()
    xr = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(compiled(loss)(xr), xr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind", ["tuple", "ndarray", "tensor"])
def test_compiled_cwt_follows_its_scales_argument(kind):
    """Scales passed to a compiled ``cwt``: each call's own scales give
    that call's coefficients and frequencies (python scales are guarded
    constants, an array or tensor is read at a graph break), and
    ``fullgraph=True`` refuses an array of scales."""
    x = torch.from_numpy(row_input("cwt"))

    def transform(t, scales):
        coeffs, freqs = tptwt.cwt(t, scales, "mexh")
        return coeffs, torch.as_tensor(freqs)

    torch._dynamo.reset()
    graph = torch.compile(transform, backend="aot_eager", dynamic=False)
    for values in (np.arange(1, 16), np.arange(2, 17), np.linspace(1.5, 9.0, 15)):
        scales = {"tuple": tuple(values.tolist()), "ndarray": values, "tensor": torch.from_numpy(values)}[kind]
        (got, got_f), (want, want_f) = graph(x, scales), transform(x, scales)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got_f.numpy(), want_f.numpy())
        jwant, _ = jptwt.cwt(jnp.asarray(x.numpy()), values, "mexh")
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-5 * max(1.0, float(np.abs(jwant).max())), rtol=0)
    if kind != "tuple":
        torch._dynamo.reset()
        with pytest.raises(torch._dynamo.exc.Unsupported):
            compiled(transform)(x, scales)


#: name -> (the port's and JAX's analysis and synthesis classes, input shape)
_MATRIX = {
    1: ("MatrixWavedec", "MatrixWaverec", (2, 64)),
    2: ("MatrixWavedec2", "MatrixWaverec2", (1, 32, 28)),
    3: ("MatrixWavedec3", "MatrixWaverec3", (1, 28, 28, 32)),
}


@pytest.mark.filterwarnings("ignore:Matrix transforms rely on QR")  # "custom" is no orthogonal family
@pytest.mark.parametrize("long_path", [False, True])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_same_named_banks_keep_their_own_operators(monkeypatch, dims, long_path):
    """Two custom banks under one name, one after the other in a process:
    each matrix transform builds its boundary operators (dense, or the
    banded long apply with the cutoff lowered) from its own filters, and
    meets the JAX package's transform of that bank, eagerly and compiled."""
    from ptwt_tpu_torch.ops import _boundary_long

    if long_path:
        monkeypatch.setattr(_boundary_long, "_LONG_CUTOFF", 8)
    dec, rec, shape = _MATRIX[dims]
    x = np.random.RandomState(7).randn(*shape)
    for source in ("db2", "db3", "sym4"):
        bank = Wavelet(source).filter_bank
        tbank, jbank = Wavelet("custom", filter_bank=bank), jptwt.wavelets.Wavelet("custom", filter_bank=bank)
        mwd, mwr = getattr(tptwt, dec)(tbank, level=2), getattr(tptwt, rec)(tbank)
        jmwd, jmwr = getattr(jptwt, dec)(jbank, level=2), getattr(jptwt, rec)(jbank)
        want = jmwd(jnp.asarray(x))
        got = mwd(torch.from_numpy(x))
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10, rtol=0)
        np.testing.assert_allclose(mwr(got).numpy(), np.asarray(jmwr(want)), atol=1e-10, rtol=0)
        if dims == 1:
            assert long_path == any(isinstance(op, _boundary_long.LongAnalysisOp) for op in mwd.fwt_matrix_list)
            torch._dynamo.reset()
            again = compiled(lambda t: mwr(mwd(t)))(torch.from_numpy(x))
            np.testing.assert_allclose(again.numpy(), np.asarray(jmwr(want)), atol=1e-10, rtol=0)


def test_same_named_banks_get_their_own_fused_runs():
    """The fused long runs' ids tell same-named banks apart."""
    from ptwt_tpu_torch.ops import _boundary_long

    runs = [
        _boundary_long.LongAnalysisRun(Wavelet("custom", filter_bank=Wavelet(source).filter_bank), (2048, 1024))
        for source in ("db2", "db3")
    ]
    ids = [_boundary_long._run_id(run) for run in runs]
    assert ids[0] != ids[1]
    for run_id, source in zip(ids, ("db2", "db3")):
        want = np.asarray(Wavelet(source).dec_lo[::-1])
        np.testing.assert_array_equal(_boundary_long._RUNS[run_id]._f_lo, want)


def test_cwt_plans_are_capped_by_bytes(monkeypatch):
    """The named wavelets' ``cwt`` plans share the operator caches' byte
    cap: with the cap below one plan, only the newest plan is kept."""
    from ptwt_tpu_torch import continuous_transform
    from ptwt_tpu_torch.ops import _matmul

    monkeypatch.setattr(_matmul, "OPERATOR_CACHE_BYTES", 1)
    continuous_transform._PLANS.clear()
    for n in (128, 256, 128):
        coeffs, _ = tptwt.cwt(torch.zeros(1, n), (1.0, 2.0), "mexh")
        assert coeffs.shape == (2, 1, n)
        assert len(continuous_transform._PLANS._store) == 1
    continuous_transform._PLANS.clear()
