"""The O(n) long-axis boundary operators of ptwt_tpu_torch
(``ops/_boundary_long.py``) on the CPU.

* The per-level ops against the dense operators (1e-10, float64), along
  the last axis and, with the ``axis`` argument, along any axis of a 2d or
  3d array; and the matrix transforms against ``ptwt_tpu`` under the same
  lowered cutoff, in 1d and on long 2d/3d axes.
* The fused runs: their glue on the numpy kernel model (``model_kernels``,
  ``tests/test_torch_kernels.py``) at the smallest lengths the gate takes,
  with the sameshift plans of K8a and K8b, the asserted spans and the
  launch counts; the same runs against the per-level ops, on the model and
  on the plain CPU path; and their gradients against ``jax.grad``.
* The cases of ``tests/test_matrix_long.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu import matmul_transform as jmt
from ptwt_tpu.ops import set_long_boundary_cutoff as j_set_cutoff
from ptwt_tpu.ops._boundary import boundary_analysis_matrix as j_analysis_matrix
from ptwt_tpu_torch import matmul_transform as tmt
from ptwt_tpu_torch.ops import _boundary_long as tbl
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import long_boundary_cutoff, set_long_boundary_cutoff
from ptwt_tpu_torch.ops._boundary import boundary_analysis_matrix, boundary_synthesis_matrix
from ptwt_tpu_torch.ops._boundary_long import (
    LongAnalysisOp,
    LongAnalysisRun,
    LongSynthesisOp,
    LongSynthesisRun,
    long_run_depth,
    long_syn_run_depth,
)
from _torch_one_thread import one_torch_thread  # noqa: F401

KEYS = ["aad", "ada", "add", "daa", "dad", "dda", "ddd"]
# the JAX references run under jit: one compile per configuration instead
# of one per primitive and shape


@pytest.fixture
def cutoff():
    """Set both packages' long-axis cutoff; restore it afterwards."""
    old = long_boundary_cutoff()

    def set_both(n):
        set_long_boundary_cutoff(n)
        j_set_cutoff(n)

    yield set_both
    set_both(old)


@pytest.fixture
def no_jax_runs(monkeypatch):
    """Keep the JAX package's long levels per level: its fused runs need
    the TPU window kernels (interpret mode on the CPU), and its per-level
    ops compute the same map."""
    monkeypatch.setattr(jmt, "long_run_depth", lambda *a: 0)
    monkeypatch.setattr(jmt, "long_syn_run_depth", lambda *a: 0)


def _leaves(coeffs):
    out = []
    for c in coeffs:
        out += [c[k] for k in KEYS] if isinstance(c, dict) else list(c) if isinstance(c, tuple) else [c]
    return out


def _close(got, want, atol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the per-level ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet", ["haar", "db2", "db5", "sym8", "coif3"])
@pytest.mark.parametrize("n", [512, 702])
@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
def test_long_ops_match_dense(wavelet, n, method):
    """``n = 702``: ``n % 4 == 2``, whose bottom edge rows differ from a
    power-of-two proxy's."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, n)
    a_mat, s_mat = boundary_analysis_matrix(wavelet, n, method), boundary_synthesis_matrix(wavelet, n, method)
    got = LongAnalysisOp(wavelet, n, method).apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), x @ a_mat.T, atol=1e-10)
    c = rng.randn(4, n)
    np.testing.assert_allclose(LongSynthesisOp(wavelet, n, method).apply(torch.from_numpy(c)).numpy(), c @ s_mat.T,
                               atol=1e-10)


@pytest.mark.parametrize("axis", [0, 1, -2, -3])
def test_long_ops_along_any_axis(axis):
    """The ``axis`` argument applies the op along that axis, with the values
    of the last-axis apply."""
    n, wavelet = 326, "coif4"
    shape = [3, 5, 7]
    shape[axis] = n
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape))
    for op in (LongAnalysisOp(wavelet, n), LongSynthesisOp(wavelet, n)):
        want = op.apply(x.movedim(axis, -1)).movedim(-1, axis)
        got = op.apply(x, axis)
        assert tuple(got.shape) == tuple(x.shape)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-13, rtol=0)


def test_long_ops_refuse_odd_or_short_lengths():
    with pytest.raises(ValueError, match="even"):
        LongAnalysisOp("db2", 101)
    with pytest.raises(ValueError, match="even"):
        LongSynthesisOp("db2", 101)
    with pytest.raises(ValueError, match="too short"):
        LongAnalysisOp("db8", 16)
    assert not tbl.long_supported("db2", 101) and not tbl.long_supported("db8", 16)


@pytest.mark.parametrize("length", [1024, 1001])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_matrix_wavedec_long_matches_jax(length, dtype, cutoff, no_jax_runs):
    x = np.random.RandomState(3).randn(3, length).astype(dtype)
    tol = 1e-10 if dtype == np.float64 else 2e-5
    cutoff(64)  # all levels long
    want = jax.jit(jptwt.MatrixWavedec("db3", 3))(jnp.asarray(x))
    dec = tptwt.MatrixWavedec("db3", 3)
    got = dec(torch.from_numpy(x))
    assert all(isinstance(m, LongAnalysisOp) for m in dec.fwt_matrix_list)
    _close(got, want, tol)
    rec = tptwt.MatrixWaverec("db3")(got)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jax.jit(jptwt.MatrixWaverec("db3"))(want)), atol=tol)
    np.testing.assert_allclose(rec.numpy()[..., :length], x, atol=10 * tol)


@pytest.mark.parametrize("separable,nonseparable", [(True, "kron"), (False, "kron")])
@pytest.mark.parametrize("hw,limit", [((96, 80), 48), ((200, 40), 64), ((1, 96, 128), 40)])
def test_matrix_wavedec2_long_axes_match_jax(hw, limit, separable, nonseparable, cutoff):
    """Both axes long, H long and W dense, and a kron image with long axes."""
    x = np.random.RandomState(4).randn(2, *hw[-2:])
    kw = {"separable": separable, "nonseparable": nonseparable}
    cutoff(limit)
    want = jax.jit(jptwt.MatrixWavedec2("db3", 2, **kw))(jnp.asarray(x))
    dec = tptwt.MatrixWavedec2("db3", 2, **kw)
    got = dec(torch.from_numpy(x))
    assert any(isinstance(op, LongAnalysisOp) for ops in dec.fwt_matrix_list for op in ops)
    _close(got, want, 1e-10)
    rec = tptwt.MatrixWaverec2("db3", **kw)(got)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jax.jit(jptwt.MatrixWaverec2("db3", **kw))(want)), atol=1e-10)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-9)


def test_matrix_wavedec3_long_axes_match_jax(cutoff):
    """W long on level 1, every axis short deeper."""
    x = np.random.RandomState(5).randn(1, 32, 48, 96)
    cutoff(40)
    want = jax.jit(jptwt.MatrixWavedec3("db2", 2))(jnp.asarray(x))
    dec = tptwt.MatrixWavedec3("db2", 2)
    got = dec(torch.from_numpy(x))
    assert isinstance(dec.fwt_matrix_list[0][2], LongAnalysisOp)
    _close(got, want, 1e-10)
    rec = tptwt.MatrixWaverec3("db2")(got)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jax.jit(jptwt.MatrixWaverec3("db2"))(want)), atol=1e-10)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10)


@pytest.mark.parametrize("route", ["plain", "glue"])
def test_long_axes_on_the_kernel_glue(request, route, cutoff):
    """On the kernel path a long level along axis -2 or -1 is one K3 launch
    (``valid``) and back one K4 launch (``zero``); the dense axes launch
    nothing."""
    counts = request.getfixturevalue("model_kernels") if route == "glue" else None
    x = np.random.RandomState(6).randn(2, 200, 40)
    cutoff(64)
    want = jax.jit(jptwt.MatrixWavedec2("db2", 2))(jnp.asarray(x))
    got = tptwt.MatrixWavedec2("db2", 2)(torch.from_numpy(x))
    _close(got, want, 1e-10)
    if counts is not None:
        assert {k: v for k, v in counts.items() if v} == {"K3": 2}  # H at 200 and 100; W dense
        _kernels.reset_launch_counts()
    rec = tptwt.MatrixWaverec2("db2")(got)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10)
    if counts is not None:
        assert {k: v for k, v in counts.items() if v} == {"K4": 2}


@pytest.mark.parametrize("wavelet,n", [("db5", 702), ("sym6", 302), ("coif4", 326), ("db8", 334)])
def test_long_ops_phase_dependent_bottom_edge(wavelet, n):
    rng = np.random.RandomState(6)
    a_mat, s_mat = boundary_analysis_matrix(wavelet, n, "qr"), boundary_synthesis_matrix(wavelet, n, "qr")
    np.testing.assert_allclose(a_mat, j_analysis_matrix(wavelet, n, "qr"), atol=1e-13)
    x, c = rng.randn(2, n), rng.randn(2, n)
    np.testing.assert_allclose(LongAnalysisOp(wavelet, n).apply(torch.from_numpy(x)).numpy(), x @ a_mat.T, atol=1e-10)
    np.testing.assert_allclose(LongSynthesisOp(wavelet, n).apply(torch.from_numpy(c)).numpy(), c @ s_mat.T,
                               atol=1e-10)


def test_long_ops_fuzz_random_lengths(cutoff):
    """Seeded sweep: random (wavelet, even length, level, cutoff) draws,
    forced long against forced dense."""
    rng = np.random.RandomState(99)
    wavs = ["db2", "db5", "sym6", "coif4", "db8"]
    for _ in range(12):
        w = wavs[rng.randint(len(wavs))]
        n = int(rng.randint(48, 400)) * 2
        lvl = int(rng.randint(1, 3))
        x = torch.from_numpy(rng.randn(1, n))
        cutoff(10**9)
        dense = tptwt.MatrixWavedec(w, level=lvl)(x)
        cutoff(int(rng.randint(32, max(33, n // 2))))
        longc = tptwt.MatrixWavedec(w, level=lvl)(x)
        for a, b in zip(dense, longc):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9, err_msg=f"{w} {n} {lvl}")
        np.testing.assert_allclose(tptwt.MatrixWaverec(w)(longc).numpy(), x.numpy(), atol=1e-9)


def test_fused_operator_raises_beyond_cutoff(cutoff):
    cutoff(64)
    dec = tptwt.MatrixWavedec("db2", level=2)
    rec = tptwt.MatrixWaverec("db2")
    rec(dec(torch.from_numpy(np.random.RandomState(0).randn(256))))
    for pkg_op in (lambda: dec.sparse_fwt_operator, lambda: rec.sparse_ifwt_operator):
        with pytest.raises(NotImplementedError, match="cutoff"):
            pkg_op()


def test_kron_factored_large_image():
    """``kron`` never builds the ``[hw, hw]`` operator: a 256x256 image runs
    factored and inverts to machine precision."""
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 256, 256))
    dec = tptwt.MatrixWavedec2("db3", level=3, separable=False)
    rec = tptwt.MatrixWaverec2("db3", separable=False)(dec(x))
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-11)
    assert all(isinstance(mats, tuple) and len(mats) == 2 for mats in dec.fwt_matrix_list)


# ---------------------------------------------------------------------------
# the fused runs
# ---------------------------------------------------------------------------

#: the shortest signals the run gates take at depths 2, 3 and 4: longer
#: than 2**16 and halving exactly that many times
SHORTEST = {2: 65540, 3: 65544, 4: 65552}


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_run_gates_at_the_shortest_lengths(depth):
    """The gates fuse ``depth`` levels of the chains ``MatrixWavedec`` and
    ``MatrixWaverec`` plan for the shortest such signal, and decline a
    first length of ``2**16`` and a chain that does not halve."""
    chain = tmt._plan_levels(SHORTEST[depth], depth + 1, 10)[1]
    assert long_run_depth("db5", chain, "qr", torch.float32) == depth
    assert long_syn_run_depth("db5", chain[::-1], "qr", torch.float32) == depth
    assert long_run_depth("db5", [1 << 16, 1 << 15, 1 << 14], "qr", torch.float32) == 0
    assert long_syn_run_depth("db5", [1 << 14, 1 << 15, 1 << 16], "qr", torch.float32) == 0
    assert long_run_depth("db5", [65538, 32770], "qr", torch.float32) == 0
    assert long_syn_run_depth("db5", [32770, 65538], "qr", torch.float32) == 0


def _capture_plans(monkeypatch):
    plans = []
    launch = _kernels.launch

    def spy(kernel, entry, device, dtype, *args):
        if entry.startswith("ptwt_fwt1d"):
            plans.append((kernel, entry, list(args[-3])))
        return launch(kernel, entry, device, dtype, *args)

    monkeypatch.setattr(_kernels, "launch", spy)
    return plans


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("wavelet,method", [("db5", "qr"), ("haar", "gramschmidt"), ("sym8", "qr")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_runs_on_the_kernel_glue(model_kernels, monkeypatch, depth, wavelet, method, dtype):  # noqa: F811
    """At the shortest length a run takes: one launch of K8a's sameshift
    plan (``_analysis_ints`` of the halving chain, offsets ``a``, no edge
    block) and one of K8b's (crops ``a``), the spans stitched, against the
    per-level ops and the plain CPU path."""
    n = SHORTEST[depth]
    lengths = [n >> i for i in range(depth)]
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, n)).to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    plans = _capture_plans(monkeypatch)
    run = LongAnalysisRun(wavelet, lengths, method)
    lo, his = run.apply(x)
    assert {k: v for k, v in model_kernels.items() if v} == {"K8a": 1}
    filt_len, a, item = run.filt_len, tbl._conv_offset(run.filt_len), x.element_size()
    want_plan, _ = t8._analysis_ints([n >> i for i in range(depth + 1)], [a] * depth, filt_len, item, [0, 0, 0, 0])
    assert plans == [("K8a", "ptwt_fwt1d_analysis", want_plan)]
    ref_lo, ref_his = run._reference(x.double())
    np.testing.assert_allclose(lo.double().numpy(), ref_lo.numpy(), atol=tol, rtol=0)
    for g, w in zip(his, ref_his):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), atol=tol, rtol=0)

    _kernels.reset_launch_counts()
    plans.clear()
    srun = LongSynthesisRun(wavelet, lengths[::-1], method)
    bands = [torch.from_numpy(rng.randn(2, m // 2)).to(dtype) for m in [lengths[-1], *lengths[::-1]]]
    out = srun.apply(bands[0], bands[1:])
    assert {k: v for k, v in model_kernels.items() if v} == {"K8b": 1}
    want_plan, _ = t8._syn_plan(filt_len, n, [m // 2 for m in lengths], [a] * depth, item)
    assert plans == [("K8b", "ptwt_fwt1d_synthesis", want_plan)]
    ref = srun._reference(bands[0].double(), [b.double() for b in bands[1:]])
    np.testing.assert_allclose(out.double().numpy(), ref.numpy(), atol=tol, rtol=0)

    # the plain CPU path: the same values
    monkeypatch.setattr(t8, "_on_cpu", lambda t: True)
    plain_lo, plain_his = run.apply(x)
    np.testing.assert_allclose(plain_lo.numpy(), lo.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(srun.apply(bands[0], bands[1:]).numpy(), out.numpy(), atol=tol, rtol=0)


def test_run_spans_cover_the_kernels_wrong_positions(monkeypatch):
    """The construction asserts, level by level, that the stitched spans
    cover every position where the zero-extended cone differs from the
    band: spans that stop short of the edge rows fail it (db5's boundary
    rows differ from the plain correlation; haar has none)."""
    n = SHORTEST[3]
    run = LongAnalysisRun("db5", [n, n // 2, n // 4])
    assert all(w_l >= 5 and w_r >= 5 for _, w_l, w_r in run._spans)
    for end in (0, 1):
        short = tuple((half, 1 if end == 0 else w_l, 1 if end == 1 else w_r) for half, w_l, w_r in run._spans)
        monkeypatch.setattr(LongAnalysisRun, "_edge_spans", lambda self, short=short: short)
        with pytest.raises(AssertionError, match="past the span"):
            LongAnalysisRun("db5", [n, n // 2, n // 4])
        monkeypatch.setattr(LongSynthesisRun, "_edge_spans", lambda self, end=end: [(1, 1)] * 3)
        with pytest.raises(AssertionError, match="past the span"):
            LongSynthesisRun("db5", [n // 4, n // 2, n])
    monkeypatch.undo()
    LongAnalysisRun("haar", [n, n // 2, n // 4])


def test_runs_refuse_broken_chains():
    with pytest.raises(ValueError, match="halving"):
        LongAnalysisRun("db5", [65552, 32770])
    with pytest.raises(ValueError, match="doubling"):
        LongSynthesisRun("db5", [32770, 65552])
    with pytest.raises(ValueError, match="too short"):
        LongAnalysisRun("db5", [32, 16])
    with pytest.raises(ValueError, match="too short"):
        LongSynthesisRun("db5", [16, 32])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_matrix_transforms_fuse_on_the_kernel_glue(model_kernels, dtype, no_jax_runs):  # noqa: F811
    """``MatrixWavedec("db5", 6)`` on the shortest depth-4 signal: one K8a
    launch (levels 1-4), then K3 for the two long levels left; back two K4
    launches and one K8b launch; against ``ptwt_tpu`` level by level."""
    n = SHORTEST[4]
    x = np.random.RandomState(8).randn(2, n).astype(dtype)
    tol = 1e-10 if dtype == np.float64 else 2e-5
    dec = tptwt.MatrixWavedec("db5", 6)
    got = dec(torch.from_numpy(x))
    assert list(dec._runs) == [0] and dec._runs[0].depth == 4
    assert {k: v for k, v in model_kernels.items() if v} == {"K8a": 1, "K3": 2}
    want = jax.jit(jptwt.MatrixWavedec("db5", 6))(jnp.asarray(x))
    _close(got, want, tol)
    _kernels.reset_launch_counts()
    rec = tptwt.MatrixWaverec("db5")
    out = rec(got)
    assert rec._syn_run[0] == 2 and rec._syn_run[1].depth == 4
    assert {k: v for k, v in model_kernels.items() if v} == {"K4": 2, "K8b": 1}
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jptwt.MatrixWaverec("db5"))(want)), atol=tol)
    np.testing.assert_allclose(out.numpy(), x, atol=10 * tol)


@pytest.mark.parametrize("route", ["plain", "glue"])
def test_run_gradients_match_jax(request, route, no_jax_runs):
    """Gradients through a fused round trip against ``jax.grad`` through
    the JAX per-level ops.  On the kernel path each run's backward is the
    VJP of its per-level chain, which runs the chain (the level longer
    than ``2**16`` on K7, the other on K3/K4) and each launch's twin."""
    counts = request.getfixturevalue("model_kernels") if route == "glue" else None
    n = SHORTEST[2]
    rng = np.random.RandomState(9)
    x = rng.randn(1, n)
    jc = jax.jit(jptwt.MatrixWavedec("db2", 2))(jnp.asarray(x))
    weights = [rng.randn(*c.shape) for c in jc] + [rng.randn(1, n)]

    def loss(pkg, z, ws):
        coeffs = pkg.MatrixWavedec("db2", 2)(z)
        return sum((c * w).sum() for c, w in zip([*coeffs, pkg.MatrixWaverec("db2")(coeffs)], ws))

    want = jax.jit(jax.grad(lambda z: loss(jptwt, z, [jnp.asarray(w) for w in weights])))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    value = loss(tptwt, xt, [torch.from_numpy(w) for w in weights])
    if counts is not None:
        assert {k: v for k, v in counts.items() if v} == {"K8a": 1, "K8b": 1}
        _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(value, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10, rtol=0)
    if counts is not None:
        # the analysis run's chain: K7a (65540) and K3 (32770), their VJPs
        # K7b and K4; the synthesis run's: K4 and K7b, their VJPs K3 and K7a
        assert {k: v for k, v in counts.items() if v} == {"K3": 2, "K4": 2, "K7a": 2, "K7b": 2}


# ---------------------------------------------------------------------------
# the cases of tests/test_matrix_long.py
# ---------------------------------------------------------------------------


def test_matrix_wavedec_long_signal_smoke():
    """A deep db5 decomposition of a long float32 signal (the 10**6 row
    runs on the card, ``chip_smoke.py`` phase 15)."""
    n = 2**17
    x = torch.from_numpy(np.random.RandomState(3).randn(2, n).astype(np.float32))
    dec = tptwt.MatrixWavedec("db5", level=8)
    coeffs = dec(x)
    assert len(coeffs) == 9 and any(isinstance(m, LongAnalysisOp) for m in dec.fwt_matrix_list)
    assert dec._runs and dec._runs[0].depth == 4
    np.testing.assert_allclose(tptwt.MatrixWaverec("db5")(coeffs).numpy()[..., :n], x.numpy(), atol=5e-4)


@pytest.mark.parametrize("wavelet", ["haar", "db5", "sym8"])
@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
@pytest.mark.parametrize("n", [2**17, 140000])
def test_long_run_matches_per_level_ops(wavelet, method, n):
    lengths = [n, n // 2, n // 4]
    run = LongAnalysisRun(wavelet, lengths, method)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, n).astype(np.float32))
    lo, his = run.apply(x)
    cur = x
    for n_l, got_hi in zip(lengths, his):
        packed = LongAnalysisOp(wavelet, n_l, method).apply(cur)
        cur = packed[..., : n_l // 2]
        np.testing.assert_allclose(got_hi.numpy(), packed[..., n_l // 2 :].numpy(), atol=3e-5)
    np.testing.assert_allclose(lo.numpy(), cur.numpy(), atol=3e-5)


@pytest.mark.parametrize("wavelet", ["haar", "db5"])
@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
def test_long_syn_run_matches_per_level_ops(wavelet, method):
    n_fine = 2**17
    lengths = [n_fine // 4, n_fine // 2, n_fine]
    run = LongSynthesisRun(wavelet, lengths, method)
    rng = np.random.RandomState(0)
    lo = torch.from_numpy(rng.randn(2, lengths[0] // 2).astype(np.float32))
    his = [torch.from_numpy(rng.randn(2, m // 2).astype(np.float32)) for m in lengths]
    cur = lo
    for hi, n_l in zip(his, lengths):
        cur = LongSynthesisOp(wavelet, n_l, method).apply(torch.cat([cur, hi], -1))
    np.testing.assert_allclose(run.apply(lo, his).numpy(), cur.numpy(), atol=3e-5)


def test_matrix_transforms_fused_runs_public(monkeypatch):
    """``MatrixWavedec``/``MatrixWaverec`` with their runs match the
    per-level path and invert each other."""
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 140000).astype(np.float32))
    dec = tptwt.MatrixWavedec("db4", 6)
    got = dec(x)
    assert dec._runs, "the gate should have produced a fused run"
    rec = tptwt.MatrixWaverec("db4")
    out = rec(got)
    assert rec._syn_run is not None, "the gate should have fused the synthesis"
    monkeypatch.setattr(tmt, "long_run_depth", lambda *a: 0)
    monkeypatch.setattr(tmt, "long_syn_run_depth", lambda *a: 0)
    dec2, rec2 = tptwt.MatrixWavedec("db4", 6), tptwt.MatrixWaverec("db4")
    ref = dec2(x)
    assert not dec2._runs
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=3e-5)
    np.testing.assert_allclose(out.numpy(), rec2(ref).numpy(), atol=3e-5)
    assert rec2._syn_run is None
    np.testing.assert_allclose(out.numpy()[..., :140000], x.numpy(), atol=1e-3)
