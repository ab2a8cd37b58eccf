"""The boundary-wavelet matrix transforms of ptwt_tpu_torch against ptwt_tpu
on the CPU: the dense path and the operators.

The same numpy inputs, made from a seed, go through both packages:
``MatrixWavedec``/``MatrixWaverec`` in 1d, 2d (separable, ``kron`` and
``reference``) and 3d, QR and Gram-Schmidt, odd shapes, ``axis``/``axes``,
float32 (2e-5) and float64 (1e-12); the fused ``sparse_*_operator``
matrices entry by entry against the JAX-built ones; the ``sparse_math``
helpers; every error path; and gradients against ``jax.grad``.  Also the
cases of ``tests/test_matrix_fwt.py``, ``test_matrix_fwt_2.py`` and
``test_sparse_math.py``.  The long-axis apply has its own file,
``tests/test_torch_matrix_long.py``.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu import matmul_transform as jmt
from ptwt_tpu import matmul_transform_2 as jmt2
from ptwt_tpu import sparse_math as jsm
from ptwt_tpu_torch import matmul_transform as tmt
from ptwt_tpu_torch import matmul_transform_2 as tmt2
from ptwt_tpu_torch import sparse_math as tsm
from ptwt_tpu_torch.ops import _conv, get_precision, set_precision
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL = {np.float32: 2e-5, np.float64: 1e-12}
KEYS = ["aad", "ada", "add", "daa", "dad", "dda", "ddd"]
CPU = torch.device("cpu")


def _leaves(coeffs):
    out = []
    for c in coeffs:
        if isinstance(c, dict):
            assert list(c) == KEYS
            out += [c[k] for k in KEYS]
        elif isinstance(c, tuple):
            out += list(c)
        else:
            out.append(c)
    return out


def _assert_close(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


def _pair(dim):
    return {
        1: (jptwt.MatrixWavedec, jptwt.MatrixWaverec, tptwt.MatrixWavedec, tptwt.MatrixWaverec),
        2: (jptwt.MatrixWavedec2, jptwt.MatrixWaverec2, tptwt.MatrixWavedec2, tptwt.MatrixWaverec2),
        3: (jptwt.MatrixWavedec3, jptwt.MatrixWaverec3, tptwt.MatrixWavedec3, tptwt.MatrixWaverec3),
    }[dim]


def _round_trip(dim, x, wavelet, level, tol, dec_kw=None, rec_kw=None):
    """Both packages' analysis and synthesis on ``x``; returns the port's
    objects and reconstruction."""
    jdec_cls, jrec_cls, tdec_cls, trec_cls = _pair(dim)
    dec_kw, rec_kw = dec_kw or {}, rec_kw or {}
    # the JAX reference under jit, one compile per configuration (its
    # "reference" backend builds its operators from the traced input)
    jit = (lambda f: f) if dec_kw.get("nonseparable") == "reference" else jax.jit
    want = jit(jdec_cls(wavelet, level, **dec_kw))(jnp.asarray(x))
    tdec = tdec_cls(wavelet, level, **dec_kw)
    got = tdec(torch.from_numpy(x))
    assert type(got) is type(want)
    _assert_close(got, want, tol)
    rec_want = np.asarray(jit(jrec_cls(wavelet, **rec_kw))(want))
    trec = trec_cls(wavelet, **rec_kw)
    rec = trec(got)
    assert tuple(rec.shape) == rec_want.shape and rec.dtype == got[0].dtype
    np.testing.assert_allclose(rec.numpy(), rec_want, atol=tol, rtol=0)
    return tdec, trec, rec


def _crop(rec, x):
    return rec.numpy()[tuple(slice(0, s) for s in x.shape)]


# ---------------------------------------------------------------------------
# the transforms against ptwt_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
@pytest.mark.parametrize(
    "wavelet,shape,level",
    # even, odd and padded chains; a batch of several dims; the default level
    [("haar", (2, 32), 3), ("db3", (3, 33), 2), ("sym4", (2, 50), None), ("db5", (2, 3, 61), 2),
     ("coif2", (1, 128), 3)],
)
def test_matrix_1d_matches_jax(wavelet, shape, level, method, dtype):
    x = np.random.RandomState(60).randn(*shape).astype(dtype)
    kw = {"orthogonalization": method}
    _, _, rec = _round_trip(1, x, wavelet, level, TOL[dtype], kw, kw)
    np.testing.assert_allclose(_crop(rec, x), x, atol=10 * TOL[dtype], rtol=0)


@pytest.mark.parametrize("mode", ["zero", "constant"])
def test_odd_coeff_padding_mode_matches_jax(mode):
    """An odd approximation is extended by a zero or by its last sample."""
    x = np.random.RandomState(61).randn(2, 45)
    _round_trip(1, x, "db2", 3, 1e-12, {"odd_coeff_padding_mode": mode})


@pytest.mark.parametrize("axis", [0, 1, -2])
def test_axis_argument_matches_jax(axis):
    x = np.random.RandomState(62).randn(20, 24, 3)
    _, _, rec = _round_trip(1, x, "db2", 2, 1e-12, {"axis": axis}, {"axis": axis})
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "separable,nonseparable",
    [(True, "kron"), (False, "kron"), (False, "reference")],
)
@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
@pytest.mark.parametrize("shape,wavelet", [((2, 16, 16), "db2"), ((1, 2, 17, 14), "sym3"), ((2, 13, 11), "haar")])
def test_matrix_2d_matches_jax(shape, wavelet, method, separable, nonseparable, dtype):
    x = np.random.RandomState(63).randn(*shape).astype(dtype)
    kw = {"separable": separable, "nonseparable": nonseparable, "orthogonalization": method}
    _, _, rec = _round_trip(2, x, wavelet, 2, TOL[dtype], kw, kw)
    np.testing.assert_allclose(_crop(rec, x), x, atol=10 * TOL[dtype], rtol=0)


@pytest.mark.parametrize("axes", [(0, 1), (-1, -3), (2, 0)])
def test_axes_argument_2d_matches_jax(axes):
    x = np.random.RandomState(64).randn(16, 3, 12)
    _round_trip(2, x, "db2", 1, 1e-12, {"axes": axes}, {"axes": axes})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
@pytest.mark.parametrize("shape,wavelet,level", [((16, 16, 16), "db2", 2), ((2, 17, 16, 15), "sym3", 1),
                                                 ((1, 8, 10, 12), "haar", None)])
def test_matrix_3d_matches_jax(shape, wavelet, level, method, dtype):
    x = np.random.RandomState(65).randn(*shape).astype(dtype)
    kw = {"orthogonalization": method}
    _, _, rec = _round_trip(3, x, wavelet, level, TOL[dtype], kw, kw)
    np.testing.assert_allclose(_crop(rec, x), x, atol=10 * TOL[dtype], rtol=0)


def test_axes_argument_3d_matches_jax():
    axes = (0, 2, 3)
    x = np.random.RandomState(66).randn(12, 2, 10, 8)
    _round_trip(3, x, "db2", 1, 1e-12, {"axes": axes}, {"axes": axes})


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_empty_batch_matches_jax(dim):
    shape = {1: (0, 32), 2: (0, 16, 16), 3: (0, 8, 8, 8)}[dim]
    x = np.zeros(shape)
    _, _, rec = _round_trip(dim, x, "db2", 1, 0.0)
    assert tuple(rec.shape) == shape


# ---------------------------------------------------------------------------
# the operators, entry by entry
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
@pytest.mark.parametrize("wavelet,n,level", [("db2", 32, 3), ("haar", 16, 4), ("sym4", 64, 2)])
def test_fused_operators_1d_match_jax(wavelet, n, level, method):
    x = np.random.RandomState(67).randn(n)
    kw = {"orthogonalization": method}
    tdec, trec, _ = _round_trip(1, x, wavelet, level, 1e-12, kw, kw)
    jdec = jptwt.MatrixWavedec(wavelet, level, **kw)
    jrec = jptwt.MatrixWaverec(wavelet, **kw)
    jrec(jdec(jnp.asarray(x)))
    for got, want in ((tdec.sparse_fwt_operator, jdec.sparse_fwt_operator),
                      (trec.sparse_ifwt_operator, jrec.sparse_ifwt_operator),
                      (tdec.fwt_operator, jdec.fwt_operator), (trec.ifwt_operator, jrec.ifwt_operator)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-12, rtol=0)
    for got, want in zip(tdec.fwt_matrix_list, jdec.fwt_matrix_list):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-12, rtol=0)


@pytest.mark.parametrize("nonseparable", ["kron", "reference"])
@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 16, 8)])
def test_fused_operators_2d_match_jax(shape, nonseparable):
    x = np.random.RandomState(68).randn(*shape)
    kw = {"separable": False, "nonseparable": nonseparable}
    tdec, trec, _ = _round_trip(2, x, "db2", 2, 1e-12, kw, kw)
    jdec, jrec = jptwt.MatrixWavedec2("db2", 2, **kw), jptwt.MatrixWaverec2("db2", **kw)
    jrec(jdec(jnp.asarray(x)))
    np.testing.assert_allclose(_np(tdec.sparse_fwt_operator), _np(jdec.sparse_fwt_operator), atol=1e-12, rtol=0)
    np.testing.assert_allclose(_np(trec.sparse_ifwt_operator), _np(jrec.sparse_ifwt_operator), atol=1e-12, rtol=0)


@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4", "sym5", "coif2"])
def test_boundary_constructors_match_jax(wavelet, method):
    for t_fn, j_fn in ((tmt.construct_boundary_a, jmt.construct_boundary_a),
                       (tmt.construct_boundary_s, jmt.construct_boundary_s)):
        got = t_fn(wavelet, 32, orthogonalization=method, device=CPU)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(_np(got), _np(j_fn(wavelet, 32, orthogonalization=method)), atol=1e-12, rtol=0)
    for t_fn, j_fn in ((tmt2.construct_boundary_a2, jmt2.construct_boundary_a2),
                       (tmt2.construct_boundary_s2, jmt2.construct_boundary_s2)):
        got = t_fn(wavelet, 16, 12, orthogonalization=method, dtype=torch.float32, device=CPU)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(j_fn(wavelet, 16, 12, orthogonalization=method)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        _np(tmt2._reference_a2_np(wavelet, 10, 12, method)), _np(jmt2._reference_a2_np(wavelet, 10, 12, method)),
        atol=1e-12, rtol=0,
    )
    np.testing.assert_allclose(
        _np(tmt2._reference_s2_np(wavelet, 10, 12, method)), _np(jmt2._reference_s2_np(wavelet, 10, 12, method)),
        atol=1e-12, rtol=0,
    )


@pytest.mark.parametrize("method", ["qr", "gramschmidt"])
def test_orthogonalize_matches_jax(method):
    raw = np.asarray(jsm.construct_strided_conv_matrix(np.asarray(jptwt.wavelets.Wavelet("db3").dec_lo), 16, 2,
                                                       mode="sameshift"))
    got = tmt.orthogonalize(torch.from_numpy(raw.copy()), 6, method)
    np.testing.assert_allclose(got.numpy(), _np(jmt.orthogonalize(jnp.asarray(raw), 6, method)), atol=1e-12)


def test_constructors_follow_their_inputs_device():
    """A constructor given a tensor returns its result on that tensor's device;
    with neither a tensor nor ``device`` it goes to the CUDA device."""
    assert tsm.construct_conv_matrix(torch.ones(3), 8).device == CPU
    assert tsm.cat_sparse_identity_matrix(torch.eye(2), 3).device == CPU
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, the constructors' results go there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsm.construct_conv_matrix(np.ones(3), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmt.construct_boundary_a("haar", 8)


# ---------------------------------------------------------------------------
# sparse_math against ptwt_tpu and scipy (the cases of test_sparse_math.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filt_len", [2, 3, 4])
@pytest.mark.parametrize("signal_len", [8, 9])
@pytest.mark.parametrize("padding", ["full", "same", "valid"])
def test_conv_matrix(filt_len, signal_len, padding):
    rng = np.random.RandomState(filt_len * 10 + signal_len)
    filt, signal = rng.rand(filt_len), rng.rand(signal_len)
    mat = tsm.construct_conv_matrix(filt, signal_len, mode=padding, device=CPU)
    np.testing.assert_allclose(mat.numpy(), np.asarray(jsm.construct_conv_matrix(filt, signal_len, mode=padding)))
    assert np.allclose(mat.numpy() @ signal, scipy.signal.convolve(signal, filt, padding))


@pytest.mark.parametrize("filt_len", [2, 3, 4])
@pytest.mark.parametrize("signal_len", [8, 9, 16])
@pytest.mark.parametrize("padding", ["full", "valid", "same", "sameshift"])
def test_strided_conv_matrix(filt_len, signal_len, padding):
    rng = np.random.RandomState(filt_len * 10 + signal_len)
    filt, signal = rng.rand(filt_len), rng.rand(signal_len)
    strided = tsm.construct_strided_conv_matrix(filt, signal_len, 2, mode=padding, device=CPU).numpy()
    np.testing.assert_allclose(strided, np.asarray(jsm.construct_strided_conv_matrix(filt, signal_len, 2, mode=padding)))
    if padding in ("same", "sameshift"):
        base = tsm.construct_conv_matrix(filt, signal_len, mode="same", device=CPU).numpy()
        expected = base[(1 if padding == "sameshift" else 0)::2] @ signal
    else:
        expected = scipy.signal.convolve(signal, filt, padding)[::2]
    assert np.allclose(strided @ signal, expected)


@pytest.mark.parametrize("filt_shape", [(2, 2), (3, 3), (3, 2), (2, 3)])
@pytest.mark.parametrize("size", [(8, 8), (16, 8), (8, 16)])
@pytest.mark.parametrize("padding", ["full", "valid"])
def test_conv_matrix_2d(filt_shape, size, padding):
    rng = np.random.RandomState(sum(filt_shape) + size[0])
    filt, image = rng.randn(*filt_shape), rng.randn(*size)
    mat = tsm.construct_conv2d_matrix(filt, size[0], size[1], mode=padding, device=CPU).numpy()
    np.testing.assert_allclose(mat, np.asarray(jsm.construct_conv2d_matrix(filt, size[0], size[1], mode=padding)))
    expected = scipy.signal.convolve2d(image, filt, mode=padding)
    assert np.allclose(expected, (mat @ image.flatten(order="F")).reshape(expected.shape, order="F"))


@pytest.mark.parametrize("filt_shape", [(2, 2), (3, 3), (4, 4)])
@pytest.mark.parametrize("size", [(8, 8), (16, 16), (8, 16)])
@pytest.mark.parametrize("padding", ["full", "sameshift"])
def test_strided_conv_matrix_2d(filt_shape, size, padding):
    rng = np.random.RandomState(sum(filt_shape) + size[1])
    filt, image = rng.randn(*filt_shape), rng.randn(*size)
    strided = tsm.construct_strided_conv2d_matrix(torch.from_numpy(filt), size[0], size[1], 2, mode=padding).numpy()
    want = np.asarray(jsm.construct_strided_conv2d_matrix(filt, size[0], size[1], 2, mode=padding))
    np.testing.assert_allclose(strided, want)
    if padding == "full":
        expected = scipy.signal.convolve2d(image, filt, mode="full")[::2, ::2]
        assert np.allclose(expected, (strided @ image.flatten(order="F")).reshape(expected.shape, order="F"))


def test_kron():
    a = np.array([[1.0, 2], [3, 2], [5, 6]])
    b = np.array([[7.0, 8], [9, 0]])
    np.testing.assert_allclose(tsm.sparse_kron(torch.from_numpy(a), b).numpy(), np.kron(a, b))


def test_cat_sparse_identity_matrix():
    rng = np.random.RandomState(42)
    mat = tsm.construct_conv_matrix(rng.rand(3), 6, mode="same", device=CPU)
    ext = tsm.cat_sparse_identity_matrix(mat, 10)
    np.testing.assert_allclose(ext.numpy(), np.asarray(jsm.cat_sparse_identity_matrix(mat.numpy(), 10)))
    vec = rng.rand(10)
    np.testing.assert_allclose(ext.numpy() @ vec, np.concatenate([mat.numpy() @ vec[:6], vec[6:]]))


def test_batch_mm():
    rng = np.random.RandomState(43)
    matrix, batched = rng.randn(6, 8), rng.randn(4, 8, 5)
    got = tsm.batch_mm(matrix, torch.from_numpy(batched))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsm.batch_mm(matrix, jnp.asarray(batched))), atol=1e-12)


# ---------------------------------------------------------------------------
# error paths: the port raises where ptwt_tpu raises, with the same type
# ---------------------------------------------------------------------------


def _both_raise(exc, jax_call, torch_call, match=None):
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        torch_call()


def test_operator_error_paths_match_jax():
    x16 = np.random.RandomState(69).randn(16)
    # no operator before the first call
    _both_raise(ValueError, lambda: jptwt.MatrixWavedec("haar").sparse_fwt_operator,
                lambda: tptwt.MatrixWavedec("haar").sparse_fwt_operator, "Call the transform")
    _both_raise(ValueError, lambda: jptwt.MatrixWaverec("haar").sparse_ifwt_operator,
                lambda: tptwt.MatrixWaverec("haar").sparse_ifwt_operator, "Call the transform")
    _both_raise(ValueError, lambda: jptwt.MatrixWavedec2("haar").sparse_fwt_operator,
                lambda: tptwt.MatrixWavedec2("haar").sparse_fwt_operator, "Call the transform")
    _both_raise(ValueError, lambda: jptwt.MatrixWaverec2("haar").sparse_ifwt_operator,
                lambda: tptwt.MatrixWaverec2("haar").sparse_ifwt_operator, "Call the transform")
    # a padded chain has no fused operator
    x12 = np.random.RandomState(70).randn(12)
    jd, td = jptwt.MatrixWavedec("haar", 3), tptwt.MatrixWavedec("haar", 3)
    jc, tc = jd(jnp.asarray(x12)), td(torch.from_numpy(x12))
    _both_raise(NotImplementedError, lambda: jd.sparse_fwt_operator, lambda: td.sparse_fwt_operator, "pad-free")
    jr, tr = jptwt.MatrixWaverec("haar"), tptwt.MatrixWaverec("haar")
    jr(jc)
    tr(tc)
    _both_raise(NotImplementedError, lambda: jr.sparse_ifwt_operator, lambda: tr.sparse_ifwt_operator, "pad-free")
    # 2d: separable has no fused operator; a padded chain neither
    x2 = np.random.RandomState(71).randn(1, 20, 20)
    for sep in (True, False):
        jd2 = jptwt.MatrixWavedec2("haar", 3, separable=sep)
        td2 = tptwt.MatrixWavedec2("haar", 3, separable=sep)
        jc2, tc2 = jd2(jnp.asarray(x2)), td2(torch.from_numpy(x2))
        _both_raise(NotImplementedError, lambda: jd2.sparse_fwt_operator, lambda: td2.sparse_fwt_operator)
        jr2 = jptwt.MatrixWaverec2("haar", separable=sep)
        tr2 = tptwt.MatrixWaverec2("haar", separable=sep)
        jr2(jc2)
        tr2(tc2)
        _both_raise(NotImplementedError, lambda: jr2.sparse_ifwt_operator, lambda: tr2.sparse_ifwt_operator)
    # mismatched coefficient lengths
    jc16 = jptwt.MatrixWavedec("haar", 2)(jnp.asarray(x16))
    tc16 = tptwt.MatrixWavedec("haar", 2)(torch.from_numpy(x16))
    _both_raise(ValueError, lambda: jptwt.MatrixWaverec("haar")([jc16[0][:-2], *jc16[1:]]),
                lambda: tptwt.MatrixWaverec("haar")([tc16[0][:-2], *tc16[1:]]), "matching shapes")


def test_constructor_and_container_error_paths_match_jax():
    _both_raise(ValueError, lambda: jptwt.MatrixWavedec2("haar", nonseparable="dense"),
                lambda: tptwt.MatrixWavedec2("haar", nonseparable="dense"), "nonseparable")
    _both_raise(ValueError, lambda: jptwt.MatrixWaverec2("haar", nonseparable="dense"),
                lambda: tptwt.MatrixWaverec2("haar", nonseparable="dense"), "nonseparable")
    _both_raise(ValueError, lambda: jptwt.MatrixWaverec2("haar")((jnp.ones((4, 4)), jnp.ones((4, 4)))),
                lambda: tptwt.MatrixWaverec2("haar")((torch.ones(4, 4), torch.ones(4, 4))), "detail coefficient")
    _both_raise(ValueError, lambda: jptwt.MatrixWaverec3("haar")((jnp.ones((2, 2, 2)), {"aad": jnp.ones((2, 2, 2))})),
                lambda: tptwt.MatrixWaverec3("haar")((torch.ones(2, 2, 2), {"aad": torch.ones(2, 2, 2)})),
                "7-entry")
    _both_raise(ValueError, lambda: jptwt.MatrixWavedec("haar")(jnp.ones(())),
                lambda: tptwt.MatrixWavedec("haar")(torch.ones(())), "At least 1")
    _both_raise(ValueError, lambda: jmt.orthogonalize(jnp.ones((4, 8)), 2, "householder"),
                lambda: tmt.orthogonalize(torch.ones(4, 8), 2, "householder"), "orthogonalization")
    _both_raise(ValueError, lambda: jsm.construct_conv_matrix(np.ones(3), 8, mode="invalid_mode"),
                lambda: tsm.construct_conv_matrix(np.ones(3), 8, mode="invalid_mode", device=CPU), "not supported")
    valid = np.asarray(jsm.construct_conv_matrix(np.ones(3), 6, mode="valid"))
    _both_raise(ValueError, lambda: jsm.cat_sparse_identity_matrix(valid, 10),
                lambda: tsm.cat_sparse_identity_matrix(torch.from_numpy(valid), 10), "square")
    _both_raise(ValueError, lambda: jsm.cat_sparse_identity_matrix(np.eye(6), 4),
                lambda: tsm.cat_sparse_identity_matrix(torch.eye(6), 4), "negatively")
    _both_raise(ValueError, lambda: jsm.cat_sparse_identity_matrix(np.ones(6), 8),
                lambda: tsm.cat_sparse_identity_matrix(torch.ones(6), 8), "2d")
    with pytest.raises(ValueError, match="dtype"):
        tptwt.MatrixWavedec("haar")(torch.ones(8, dtype=torch.float16))


def test_deprecated_alias_matches_jax():
    for pkg in (jptwt, tptwt):
        with pytest.warns(DeprecationWarning, match="orthogonalization"):
            dec = pkg.MatrixWavedec("db2", 1, boundary="gramschmidt")
        assert dec.orthogonalization == "gramschmidt"
        with pytest.raises(TypeError, match="both"):
            pkg.MatrixWaverec2("db2", boundary="qr", orthogonalization="qr")
    with pytest.warns(DeprecationWarning):
        got = tmt.construct_boundary_a("db2", 8, boundary="gramschmidt", device=CPU)
    np.testing.assert_allclose(got.numpy(), _np(jmt.construct_boundary_a("db2", 8, orthogonalization="gramschmidt")))


def test_warnings_match_jax(capsys):
    for pkg in (jptwt, tptwt):
        with pytest.warns(UserWarning, match="orthogonal"):
            pkg.MatrixWavedec("bior2.2", level=1)
    x = np.random.RandomState(72).randn(32)
    tptwt.MatrixWavedec("db4", level=10)(torch.from_numpy(x))
    assert "clamping" in capsys.readouterr().err
    with pytest.warns(UserWarning, match="clamping"):
        tptwt.MatrixWavedec2("db4", level=10)(torch.zeros(1, 16, 16))
    with pytest.warns(UserWarning, match="clamping"):
        tptwt.MatrixWavedec3("db4", level=10)(torch.zeros(1, 16, 16, 16))


def test_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.MatrixWavedec("haar", 1)(np.zeros(8, dtype=np.float32))


# ---------------------------------------------------------------------------
# the precision of the products
# ---------------------------------------------------------------------------


def test_precision_knob():
    assert get_precision() == "highest"
    with pytest.raises(ValueError, match="precision"):
        set_precision("bfloat16")
    set_precision("high")
    try:
        assert get_precision() == "high"
    finally:
        set_precision("highest")


def test_products_restore_the_callers_precision():
    """Each product sets the transforms' precision around itself and
    restores the caller's setting, forward and backward."""
    prev = torch.get_float32_matmul_precision()
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    torch.set_float32_matmul_precision("high")
    try:
        torch.Tensor.__matmul__ = spy
        x = torch.randn(2, 16, dtype=torch.float32, requires_grad=True)
        coeffs = tptwt.MatrixWavedec("db2", 2)(x)
        torch.autograd.grad(sum(c.sum() for c in coeffs), x)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.Tensor.__matmul__ = real
        torch.set_float32_matmul_precision(prev)
    assert len(seen) >= 4 and set(seen) == {"highest"}
    assert _conv.get_precision() == "highest"


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------


def _loss(dim, pkg, x, wavelet, weights, kw):
    jdec, jrec, tdec, trec = _pair(dim)
    dec, rec = (jdec, jrec) if pkg is jptwt else (tdec, trec)
    coeffs = dec(wavelet, 2, **kw)(x)
    out = _leaves(coeffs) + [rec(wavelet, **kw)(coeffs)]
    return sum((c * w).sum() for c, w in zip(out, weights))


@pytest.mark.parametrize(
    "dim,shape,kw",
    [(1, (2, 33), {}), (2, (1, 14, 17), {"separable": True}), (2, (1, 12, 10), {"separable": False}),
     (2, (1, 10, 12), {"separable": False, "nonseparable": "reference"}), (3, (1, 9, 8, 10), {})],
)
def test_gradients_match_jax(dim, shape, kw):
    rng = np.random.RandomState(73)
    x = rng.randn(*shape)
    jdec, jrec, _, _ = _pair(dim)
    jc = jdec("db2", 2, **kw)(jnp.asarray(x))
    shapes = [c.shape for c in _leaves(jc)] + [jrec("db2", **kw)(jc).shape]
    weights = [rng.randn(*s) for s in shapes]
    grad = jax.grad(lambda z: _loss(dim, jptwt, z, "db2", [jnp.asarray(w) for w in weights], kw))
    want = (grad if kw.get("nonseparable") == "reference" else jax.jit(grad))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(_loss(dim, tptwt, xt, "db2", [torch.from_numpy(w) for w in weights], kw), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-11, rtol=0)


# ---------------------------------------------------------------------------
# the cases of tests/test_matrix_fwt.py and test_matrix_fwt_2.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4", "sym5", "coif2"])
@pytest.mark.parametrize("length", [16, 32, 64])
def test_operator_algebra(wavelet, length):
    a = tmt.construct_boundary_a(wavelet, length, device=CPU).numpy()
    s = tmt.construct_boundary_s(wavelet, length, device=CPU).numpy()
    np.testing.assert_allclose(a @ a.T, np.eye(length), atol=1e-12)
    np.testing.assert_allclose(s @ a, np.eye(length), atol=1e-12)


@pytest.mark.parametrize("wavelet", ["haar", "db2"])
def test_operator_algebra_2d(wavelet):
    a2 = tmt2.construct_boundary_a2(wavelet, 16, 12, device=CPU).numpy()
    s2 = tmt2.construct_boundary_s2(wavelet, 16, 12, device=CPU).numpy()
    np.testing.assert_allclose(a2 @ a2.T, np.eye(16 * 12), atol=1e-12)
    np.testing.assert_allclose(s2 @ a2, np.eye(16 * 12), atol=1e-12)


def test_haar_matches_conv_wavedec():
    """Haar has no boundary effects: the matrix path equals the conv path
    (zero mode) in 1d, 2d and 3d."""
    x = torch.arange(32.0, dtype=torch.float64)
    for got, want in zip(tptwt.MatrixWavedec("haar", level=3)(x), tptwt.wavedec(x, "haar", mode="zero", level=3)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    x2 = torch.from_numpy(np.random.RandomState(9).randn(32, 32))
    mat, conv = tptwt.MatrixWavedec2("haar", level=2)(x2), tptwt.wavedec2(x2, "haar", mode="zero", level=2)
    for m, c in zip(_leaves(mat), _leaves(conv)):
        np.testing.assert_allclose(m.numpy(), c.numpy(), atol=1e-11)
    x3 = torch.from_numpy(np.random.RandomState(11).randn(16, 16, 16))
    mat, conv = tptwt.MatrixWavedec3("haar", level=1)(x3), tptwt.wavedec3(x3, "haar", mode="zero", level=1)
    for m, c in zip(_leaves(mat), _leaves(conv)):
        np.testing.assert_allclose(m.numpy(), c.numpy(), atol=1e-11)


@pytest.mark.parametrize("wavelet", ["haar", "db3", "sym4"])
@pytest.mark.parametrize("length", [32, 33, 50])
@pytest.mark.parametrize("level", [1, 2, None])
def test_matrix_roundtrip(wavelet, length, level):
    x = np.random.RandomState(42).randn(2, length)
    rec = tptwt.MatrixWaverec(wavelet)(tptwt.MatrixWavedec(wavelet, level=level)(torch.from_numpy(x)))
    np.testing.assert_allclose(rec.numpy()[..., :length], x, atol=1e-10)


def test_energy_conservation():
    x = np.random.RandomState(1).randn(64)
    coeffs = tptwt.MatrixWavedec("db2", level=3)(torch.from_numpy(x))
    np.testing.assert_allclose(sum(float((c**2).sum()) for c in coeffs), np.sum(x**2), rtol=1e-12)


def test_fused_operator_identity():
    x = torch.from_numpy(np.random.RandomState(2).randn(32))
    dec, rec = tptwt.MatrixWavedec("db2", level=3), tptwt.MatrixWaverec("db2")
    coeffs = dec(x)
    rec(coeffs)
    fwt, ifwt = dec.sparse_fwt_operator.numpy(), rec.sparse_ifwt_operator.numpy()
    np.testing.assert_allclose(ifwt @ fwt, np.eye(32), atol=1e-11)
    flat = fwt @ x.numpy()
    np.testing.assert_allclose(flat[:4], coeffs[0].numpy(), atol=1e-11)
    np.testing.assert_allclose(flat[4:8], coeffs[1].numpy(), atol=1e-11)


def test_rebuild_on_change():
    """The operators are rebuilt when the length, level or dtype changes."""
    dec = tptwt.MatrixWavedec("db2", level=2)
    c32 = dec(torch.from_numpy(np.random.RandomState(3).randn(32)))
    assert [tuple(m.shape) for m in dec.fwt_matrix_list] == [(32, 32), (16, 16)]
    c64 = dec(torch.from_numpy(np.random.RandomState(3).randn(64)))
    assert [tuple(m.shape) for m in dec.fwt_matrix_list] == [(64, 64), (32, 32)]
    assert c32[0].shape != c64[0].shape
    dec(torch.zeros(64, dtype=torch.float32))
    assert all(m.dtype == torch.float32 for m in dec.fwt_matrix_list)
    rec = tptwt.MatrixWaverec("db2")
    rec(c64)
    assert all(m.dtype == torch.float64 for m in rec.ifwt_matrix_list)


def test_call_keyword_names_match_reference():
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 32))
    out = tptwt.MatrixWaverec("db2")(coefficients=tptwt.MatrixWavedec("db2", level=2)(input_signal=x))
    np.testing.assert_allclose(out.numpy(), x.numpy(), atol=1e-12)


def test_separable_equals_nonseparable():
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 16, 16))
    c_sep = tptwt.MatrixWavedec2("db2", level=1, separable=True)(x)
    c_kron = tptwt.MatrixWavedec2("db2", level=1, separable=False)(x)
    for a, b in zip(_leaves(c_sep), _leaves(c_kron)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-11)


def test_reference_and_kron_reconstruct_alike():
    """The reference construction differs from ``kron`` by an orthogonal
    rotation of the boundary coefficients: both reconstruct exactly."""
    x = torch.from_numpy(np.random.RandomState(12).randn(2, 16, 16))
    for ns in ("kron", "reference"):
        kw = {"separable": False, "nonseparable": ns}
        rec = tptwt.MatrixWaverec2("db3", **kw)(tptwt.MatrixWavedec2("db3", 2, **kw)(x))
        np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-11)


@pytest.mark.parametrize("module", ["matmul_transform", "matmul_transform_2", "matmul_transform_3"])
def test_docstring_examples(module):
    import doctest
    import importlib

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = doctest.testmod(importlib.import_module(f"ptwt_tpu_torch.{module}"), verbose=False)
    assert result.attempted > 0 and result.failed == 0
