"""ptwt_tpu_torch's wavelet packet trees against ptwt_tpu on the CPU.

The same numpy inputs, made from a seed, fill a tree of each package, and
every node is compared (float32 within 2e-5, float64 within 1e-10): the
padded modes, periodization and the boundary-wavelet matrix backend (qr
and Gram-Schmidt), the separable 2d backend, axes that are not last, an
empty batch, a user's odd-length bank, and a gradient through
``reconstruct()`` against ``jax.grad``.  Also the cases of
``tests/test_packets.py``.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch import packets as tpackets
from _torch_one_thread import one_torch_thread  # noqa: F401

TOL = {np.float32: 2e-5, np.float64: 1e-10}
# (mode, orthogonalization): the six padded modes and the matrix backend
MODES = [(m, "qr") for m in ("zero", "constant", "reflect", "periodic", "symmetric", "periodization")] + [
    ("boundary", "qr"),
    ("boundary", "gramschmidt"),
]


def _outcome(run):
    """``run()``'s result, or the type of the exception it raised."""
    try:
        return run()
    except (ValueError, KeyError, AssertionError, TypeError, NotImplementedError) as err:
        return type(err)


def _assert_node(got, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def _assert_trees(tp, jp, tol):
    assert set(tp.data) == set(jp.data)
    for key in jp.data:
        _assert_node(tp.data[key], jp.data[key], tol)


def _trees(x, wavelet, cls_kwargs, dim):
    cls_t = tptwt.WaveletPacket if dim == 1 else tptwt.WaveletPacket2D
    cls_j = jptwt.WaveletPacket if dim == 1 else jptwt.WaveletPacket2D
    wavelet_j = wavelet if isinstance(wavelet, str) else tuple(np.asarray(f) for f in wavelet)
    return cls_t(torch.from_numpy(x), wavelet, **cls_kwargs), cls_j(jnp.asarray(x), wavelet_j, **cls_kwargs)


def _full_and_back(x, wavelet, dim, tol, **kwargs):
    """Expand both trees fully, compare every node, reconstruct both
    (or see both raise the same exception) and compare again."""
    tp, jp = _trees(x, wavelet, kwargs, dim)
    order = tp.get_level(tp.maxlevel, "natural")
    assert order == jp.get_level(jp.maxlevel, "natural")
    tp.initialize(order)
    jp.initialize(order)
    _assert_trees(tp, jp, tol)
    got, want = _outcome(tp.reconstruct), _outcome(jp.reconstruct)
    if isinstance(want, type):
        assert got is want
        return tp, None
    _assert_trees(tp, jp, tol)
    return tp, jp


def _crop(rec, x, axes):
    index = [slice(None)] * x.ndim
    for ax in axes:
        index[ax] = slice(0, x.shape[ax])
    return rec[tuple(index)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode,orth", MODES)
def test_packet1d_nodes_match_jax(mode, orth, dtype):
    x = np.random.RandomState(0).randn(3, 67).astype(dtype)
    tp, jp = _full_and_back(x, "db3", 1, TOL[dtype], mode=mode, maxlevel=3, orthogonalization=orth)
    rec = _crop(tp[""].numpy(), x, (-1,))
    np.testing.assert_allclose(rec, x, atol=10 * TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("mode,orth", MODES)
def test_packet2d_nodes_match_jax(mode, orth, separable, dtype):
    x = np.random.RandomState(1).randn(2, 23, 20).astype(dtype)
    _, jp = _full_and_back(x, "db2", 2, TOL[dtype], mode=mode, maxlevel=2, orthogonalization=orth,
                           separable=separable)
    # a separable periodization tree does not round-trip: fswaverec2 takes
    # no mode, so its padded synthesis comes back short and both packages
    # raise AssertionError in the crop to the parent
    assert (jp is None) == (separable and mode == "periodization")


@pytest.mark.parametrize("mode,orth", [("reflect", "qr"), ("periodization", "qr"), ("boundary", "gramschmidt")])
def test_packet1d_axis_not_last_matches_jax(mode, orth):
    x = np.random.RandomState(2).randn(45, 3, 2)
    _full_and_back(x, "sym4", 1, 1e-10, mode=mode, maxlevel=2, axis=0, orthogonalization=orth)


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("mode", ["symmetric", "periodization", "boundary"])
def test_packet2d_axes_not_last_matches_jax(mode, separable):
    x = np.random.RandomState(3).randn(21, 2, 26)
    _full_and_back(x, "db2", 2, 1e-10, mode=mode, maxlevel=2, axes=(0, 2), separable=separable)


@pytest.mark.parametrize("dim,shape", [(1, (0, 64)), (2, (0, 16, 18))])
@pytest.mark.parametrize("mode", ["reflect", "periodization"])
def test_packet_empty_batch_matches_jax(dim, shape, mode):
    x = np.zeros(shape)
    tp, _ = _full_and_back(x, "db2", dim, 1e-10, mode=mode, maxlevel=2)
    assert tp[""].shape[0] == 0


@pytest.mark.parametrize("mode", ["reflect", "zero", "periodic", "periodization"])
def test_packet_odd_bank_matches_jax(mode):
    """A user's 7-tap filter bank (no registry wavelet has an odd length):
    the tree needs ``maxlevel``, as ``ptwt_tpu``'s does."""
    rs = np.random.RandomState(4)
    bank = tuple(rs.randn(7) for _ in range(4))
    x = rs.randn(2, 50)
    _full_and_back(x, bank, 1, 1e-10, mode=mode, maxlevel=2)
    img = rs.randn(1, 30, 28)
    _full_and_back(img, bank, 2, 1e-10, mode=mode, maxlevel=2)


def test_packet_ripples_haar_golden():
    """Level-3 unscaled-Haar book example: a fully decomposed signal's
    ``aaa`` node is the sum over sqrt(8)."""
    x = torch.tensor([56.0, 40.0, 8.0, 24.0, 48.0, 48.0, 40.0, 16.0], dtype=torch.float64)
    wp = tptwt.WaveletPacket(x, "haar", mode="reflect", maxlevel=3)
    np.testing.assert_allclose(wp["aaa"].numpy(), [float(x.sum()) / np.sqrt(8)], atol=1e-12)


@pytest.mark.parametrize("mode", ["reflect", "zero", "boundary", "periodization"])
def test_packet_matches_stacked_wavedec(mode):
    x = torch.from_numpy(np.random.RandomState(0).randn(64))
    wp = tptwt.WaveletPacket(x, "db3", mode=mode, maxlevel=2)
    if mode == "boundary":
        a, d = tptwt.MatrixWavedec("db3", level=1)(x)
        aa, ad = tptwt.MatrixWavedec("db3", level=1)(a)
    else:
        a, d = tptwt.wavedec(x, "db3", level=1, mode=mode)
        aa, ad = tptwt.wavedec(a, "db3", level=1, mode=mode)
    for key, want in (("a", a), ("d", d), ("aa", aa), ("ad", ad)):
        np.testing.assert_allclose(wp[key].numpy(), want.numpy(), atol=1e-12)


def test_packet_lazy_and_errors_match_jax():
    x = np.random.RandomState(1).randn(32)
    tp, jp = _trees(x, "db2", {"maxlevel": 3}, 1)
    assert set(tp.data) == {""}
    _ = tp["ada"]  # expands "", "a", "ad"
    _ = jp["ada"]
    assert set(tp.data) == set(jp.data) and "ad" in tp.data and "dd" not in tp.data
    with pytest.raises(KeyError, match="too large"):
        tp["aaaa"]
    with pytest.raises(ValueError, match="Invalid key"):
        tp["ax"]
    empty = tptwt.WaveletPacket(None, "db2")
    with pytest.raises(ValueError, match="initialized"):
        empty["a"]
    for key in ("aaaa", "ax", "a3"):
        assert _outcome(lambda: tp[key]) is _outcome(lambda: jp[key])
    assert _outcome(lambda: empty["a"]) is _outcome(lambda: jptwt.WaveletPacket(None, "db2")["a"])
    # the root of an emptied tree cannot be derived
    tp.data.pop("")
    jp.data.pop("")
    assert _outcome(lambda: tp[""]) is _outcome(lambda: jp[""]) is ValueError
    # a missing child stops the reconstruction with KeyError
    tp2, jp2 = _trees(x, "db2", {"maxlevel": 2}, 1)
    tp2.initialize(["aa"])
    jp2.initialize(["aa"])
    assert _outcome(tp2.reconstruct) is _outcome(jp2.reconstruct) is KeyError
    with pytest.raises(NotImplementedError):
        tptwt.WaveletPacket2D(torch.zeros(8, 8), "db2", orthogonalization="svd")


def test_packet_deprecated_orthogonalization_alias():
    x = torch.from_numpy(np.random.RandomState(5).randn(32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wp = tptwt.WaveletPacket(x, "db2", mode="boundary", boundary_orthogonalization="gramschmidt")
    assert wp.orthogonalization == "gramschmidt"
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with pytest.raises(TypeError):
        tptwt.WaveletPacket2D(x[None, :, None] * x, "db2", boundary_orthogonalization="qr", orthogonalization="qr")


@pytest.mark.parametrize("mode", ["reflect", "zero", "boundary"])
def test_packet_reconstruct(mode):
    x = np.random.RandomState(2).randn(2, 64)
    wp = tptwt.WaveletPacket(torch.from_numpy(x), "db2", mode=mode, maxlevel=3)
    wp.initialize(tptwt.WaveletPacket.get_level(3))
    wp.reconstruct()
    np.testing.assert_allclose(wp[""].numpy(), x, atol=1e-10)


@pytest.mark.parametrize("dim", [1, 2])
def test_packet_reconstruct_after_mutation_matches_jax(dim):
    """Zeroing leaves removes their bands from the reconstruction, in both
    packages alike; the low band of a slow sine keeps it close."""
    t = np.linspace(0, 1, 128)
    x = np.sin(2 * np.pi * 4 * t) if dim == 1 else np.outer(np.sin(2 * np.pi * 2 * t[:40]), np.cos(t[:36]))[None]
    tp, jp = _trees(x, "db4", {"mode": "reflect", "maxlevel": 2}, dim)
    order = tp.get_level(2, "natural")
    tp.initialize(order)
    jp.initialize(order)
    for key in order[1:]:
        tp[key] = torch.zeros_like(tp[key])
        jp[key] = jnp.zeros_like(jp[key])
    tp.reconstruct()
    jp.reconstruct()
    _assert_trees(tp, jp, 1e-10)
    rec = _crop(tp[""].numpy(), x, (-1,) if dim == 1 else (-2, -1))
    assert np.sqrt(np.mean((rec - x) ** 2)) < 0.15


def test_graycode_orders_match_jax():
    assert tptwt.WaveletPacket.get_level(2) == ["aa", "ad", "dd", "da"]
    assert tptwt.WaveletPacket.get_level(2, "natural") == ["aa", "ad", "da", "dd"]
    assert tptwt.WaveletPacket2D.get_freq_order(1) == [["a", "v"], ["h", "d"]]
    assert tptwt.WaveletPacket2D.get_natural_order(1) == ["a", "h", "v", "d"]
    assert tptwt.WaveletPacket.get_level(3) == ["aaa", "aad", "add", "ada", "dda", "ddd", "dad", "daa"]
    assert tptwt.WaveletPacket2D.get_freq_order(2) == [
        ["aa", "av", "vv", "va"],
        ["ah", "ad", "vd", "vh"],
        ["hh", "hd", "dd", "dh"],
        ["ha", "hv", "dv", "da"],
    ]
    for level in range(5):
        for order in ("freq", "natural"):
            assert tptwt.WaveletPacket.get_level(level, order) == jptwt.WaveletPacket.get_level(level, order)
            assert tptwt.WaveletPacket2D.get_level(level, order) == jptwt.WaveletPacket2D.get_level(level, order)
        assert tpackets.get_freq_order(level) == jptwt.packets.get_freq_order(level)
        assert tpackets._wpfreq(100.0, level) == jptwt.packets._wpfreq(100.0, level)
    for cls in (tptwt.WaveletPacket, tptwt.WaveletPacket2D):
        with pytest.raises(ValueError, match="Unsupported order"):
            cls.get_level(2, "gray")


@pytest.mark.parametrize("mode", ["reflect", "zero", "boundary"])
@pytest.mark.parametrize("separable", [False, True])
def test_packet2d_matches_wavedec2(mode, separable):
    x = torch.from_numpy(np.random.RandomState(3).randn(32, 32))
    if mode == "boundary" and separable:
        # the matrix backend's separable flag picks its operators; both
        # give the same trees
        wp_s = tptwt.WaveletPacket2D(x, "db2", mode=mode, maxlevel=2, separable=True)
        wp_n = tptwt.WaveletPacket2D(x, "db2", mode=mode, maxlevel=2, separable=False)
        for key in ("a", "h", "v", "d", "aa", "dd"):
            np.testing.assert_allclose(wp_s[key].numpy(), wp_n[key].numpy(), atol=5e-6)
        return
    wp = tptwt.WaveletPacket2D(x, "db2", mode=mode, maxlevel=2, separable=separable)
    if mode == "boundary":
        a, (h, v, d) = tptwt.MatrixWavedec2("db2", level=1)(x)
    else:
        a, (h, v, d) = tptwt.wavedec2(x, "db2", level=1, mode=mode)
    for key, want in (("a", a), ("h", h), ("v", v), ("d", d)):
        np.testing.assert_allclose(wp[key].numpy(), want.numpy(), atol=1e-11)


def test_packet2d_backends_agree():
    """conv, separable-conv and matrix backends agree for haar/zero."""
    x = torch.from_numpy(np.random.RandomState(4).randn(32, 32))
    wp_conv = tptwt.WaveletPacket2D(x, "haar", mode="zero", maxlevel=2)
    wp_sep = tptwt.WaveletPacket2D(x, "haar", mode="zero", maxlevel=2, separable=True)
    wp_mat = tptwt.WaveletPacket2D(x, "haar", mode="boundary", maxlevel=2)
    for key in ("a", "h", "v", "d", "ah", "vd"):
        np.testing.assert_allclose(wp_conv[key].numpy(), wp_sep[key].numpy(), atol=1e-11)
        np.testing.assert_allclose(wp_conv[key].numpy(), wp_mat[key].numpy(), atol=1e-11)


@pytest.mark.parametrize("mode", ["reflect", "boundary"])
def test_packet2d_reconstruct(mode):
    x = np.random.RandomState(5).randn(1, 48, 48)
    wp = tptwt.WaveletPacket2D(torch.from_numpy(x), "db2", mode=mode, maxlevel=2)
    wp.initialize(tptwt.WaveletPacket2D.get_natural_order(2))
    wp.reconstruct()
    np.testing.assert_allclose(wp[""].numpy()[..., :48, :48], x, atol=1e-10)


def test_packet2d_batched_and_odd():
    x = np.random.RandomState(6).randn(3, 33, 31)
    wp = tptwt.WaveletPacket2D(torch.from_numpy(x), "db2", mode="reflect", maxlevel=2)
    assert wp["ad"].shape[0] == 3
    wp.initialize(tptwt.WaveletPacket2D.get_natural_order(2))
    wp.reconstruct()
    np.testing.assert_allclose(wp[""].numpy()[:, :33, :31], x, atol=1e-10)


def test_packet_infers_maxlevel_and_retransforms():
    x = np.random.RandomState(7).randn(2, 100)
    tp, jp = _trees(x, "db3", {}, 1)
    assert tp.maxlevel == jp.maxlevel
    y = np.random.RandomState(8).randn(2, 40, 44)
    tp2, jp2 = _trees(y, "sym4", {"mode": "periodic"}, 2)
    assert tp2.maxlevel == jp2.maxlevel
    tp.transform(torch.from_numpy(x[:, :50]), maxlevel=1)
    jp.transform(jnp.asarray(x[:, :50]), maxlevel=1)
    tp.initialize(["a", "d"])
    jp.initialize(["a", "d"])
    _assert_trees(tp, jp, 1e-10)


def _leaf_weighted_grad_jax(x, wavelet, dim, weights, ct, kwargs):
    cls = jptwt.WaveletPacket if dim == 1 else jptwt.WaveletPacket2D

    def loss(xj):
        wp = cls(xj, wavelet, **kwargs)
        order = cls.get_level(wp.maxlevel, "natural")
        wp.initialize(order)
        for key, w in zip(order, weights):
            wp[key] = wp[key] * w
        wp.reconstruct()
        return jnp.sum(wp[""] * ct)

    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


@pytest.mark.parametrize(
    "dim,shape,kwargs",
    [
        (1, (2, 45), {"mode": "reflect", "maxlevel": 3}),
        (1, (2, 48), {"mode": "periodization", "maxlevel": 2}),
        (1, (1, 40), {"mode": "boundary", "maxlevel": 2}),
        (2, (1, 22, 19), {"mode": "symmetric", "maxlevel": 2}),
        (2, (2, 20, 24), {"mode": "zero", "maxlevel": 2, "separable": True}),
        (2, (1, 16, 16), {"mode": "boundary", "maxlevel": 1}),
    ],
)
def test_packet_gradient_through_reconstruct_matches_jax(dim, shape, kwargs):
    """The gradient of a leaf-weighted loss through ``reconstruct()``,
    torch autograd against ``jax.grad`` (float64, 1e-10)."""
    rs = np.random.RandomState(9)
    x = rs.randn(*shape)
    n_leaves = (2 if dim == 1 else 4) ** kwargs["maxlevel"]
    weights = rs.uniform(0.2, 2.0, n_leaves)
    cls = tptwt.WaveletPacket if dim == 1 else tptwt.WaveletPacket2D
    xt = torch.from_numpy(x).requires_grad_(True)
    wp = cls(xt, "db2", **kwargs)
    order = cls.get_level(wp.maxlevel, "natural")
    wp.initialize(order)
    for key, w in zip(order, weights):
        wp[key] = wp[key] * float(w)
    wp.reconstruct()
    ct = rs.randn(*wp[""].shape)
    (grad,) = torch.autograd.grad((wp[""] * torch.from_numpy(ct)).sum(), xt)
    want = _leaf_weighted_grad_jax(x, "db2", dim, weights, ct, kwargs)
    np.testing.assert_allclose(grad.numpy(), want, atol=1e-10, rtol=0)
