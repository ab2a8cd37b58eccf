"""ptwt_tpu_torch.wavedec/waverec against ptwt_tpu on the CPU.

The same numpy inputs go through both packages; on CPU tensors the port
runs the plain versions of its kernels, routed level by level as the card
routes them (K6 for halving periodization chains, K8 runs and K7 levels
past ``2**16`` samples, K3/K4 otherwise).  Tolerances: float32 1e-5,
float64 1e-10.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import model_kernels  # noqa: F401

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.utils import coeffs_from_numpy, coeffs_to_numpy
from _torch_one_thread import one_torch_thread  # noqa: F401

MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = {np.float32: 1e-5, np.float64: 1e-10}
DATA = Path(__file__).parent / "data"
_GOLDENS = np.load(DATA / "transform_goldens.npz")


def _assert_coeffs(got, want, tol):
    assert isinstance(got, list)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)


def _rec_mode(mode):
    return mode if mode == "periodization" else None


def _round_trip(x, wavelet, mode, level, tol, axis=-1):
    want = jptwt.wavedec(jnp.asarray(x), wavelet, mode=mode, level=level, axis=axis)
    got = tptwt.wavedec(torch.from_numpy(x), wavelet, mode=mode, level=level, axis=axis)
    _assert_coeffs(got, want, tol)
    rec_want = jptwt.waverec(want, wavelet, mode=_rec_mode(mode), axis=axis)
    rec = tptwt.waverec(got, wavelet, mode=_rec_mode(mode), axis=axis)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_want), atol=tol, rtol=0)
    n = x.shape[axis]
    np.testing.assert_allclose(rec.numpy().take(range(n), axis=axis), x, atol=10 * tol, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape,wavelet,level",
    [((2, 33), "db3", 2), ((1, 3, 64), "sym4", None), ((4, 100), "haar", 3), ((2, 31), "coif2", 1)],
)
def test_wavedec_waverec_match_jax(shape, wavelet, level, mode, dtype):
    x = np.random.RandomState(5).randn(*shape).astype(dtype)
    _round_trip(x, wavelet, mode, level, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
def test_long_signals_match_jax(mode, dtype):
    """70001 samples: the first four levels take the fused K8 route, the
    rest K3/K4 (periodization: K3/K4, the chain does not halve)."""
    x = np.random.RandomState(6).randn(2, 70001).astype(dtype)
    _round_trip(x, "db5", mode, 6, TOL[dtype])


@pytest.mark.parametrize(
    "mode,n,level",
    [
        ("reflect", 70001, 1),  # one long level: K7
        ("symmetric", 65536, 3),  # at the gate: K3/K4
        ("zero", 65537, 2),  # one past it: a depth-2 K8 run
        ("periodization", 2**17, 10),  # halving chain: K6
        ("periodic", 70000, 5),  # even length, a K8 run and a K3 level
    ],
)
def test_routes_across_the_gate_match_jax(mode, n, level):
    x = np.random.RandomState(7).randn(2, n).astype(np.float32)
    _round_trip(x, "db4", mode, level, TOL[np.float32])


@pytest.mark.parametrize("mode", ["reflect", "periodization"])
@pytest.mark.parametrize("axis", [0, 1])
def test_axis_argument_matches_jax(mode, axis):
    x = np.random.RandomState(8).randn(36, 40, 3)
    _round_trip(x, "db2", mode, 2, 1e-10, axis=axis)


@pytest.mark.parametrize("n", [64, 96])
def test_periodization_inferred(n):
    x = torch.from_numpy(np.random.RandomState(9).randn(2, n))
    coeffs = tptwt.wavedec(x, "db2", mode="periodization", level=3)
    assert [c.shape[-1] for c in coeffs[1:]] == [n // 8, n // 4, n // 2]
    np.testing.assert_allclose(tptwt.waverec(coeffs, "db2").numpy(), x.numpy(), atol=1e-10)
    # a padded chain is not mistaken for one
    padded = tptwt.wavedec(x, "db2", mode="reflect", level=3)
    np.testing.assert_allclose(tptwt.waverec(padded, "db2").numpy()[..., :n], x.numpy(), atol=1e-10)


def _signal(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    return np.sin(0.37 * t) + 0.05 * t + np.cos(1.7 * t + 0.5)


def _cases(prefix: str) -> list[str]:
    return sorted({k.rsplit("/", 1)[0] for k in _GOLDENS.files if k.startswith(prefix)})


@pytest.mark.parametrize("key", _cases("wavedec/"))
def test_wavedec_goldens(key):
    _, name, mode, n = key.split("/")
    got = tptwt.wavedec(torch.from_numpy(_signal(int(n))), name, mode=mode, level=2)
    i = 0
    while f"{key}/{i}" in _GOLDENS:
        np.testing.assert_allclose(got[i].numpy(), _GOLDENS[f"{key}/{i}"], atol=1e-9)
        i += 1
    assert i == len(got)


@pytest.mark.parametrize("key", _cases("waverec/"))
def test_waverec_goldens(key):
    _, name, mode, n = key.split("/")
    coeffs = [torch.from_numpy(np.asarray(c)) for c in _golden_coeffs(f"wavedec/{name}/{mode}/{n}")]
    rec = tptwt.waverec(coeffs, name)
    np.testing.assert_allclose(rec.numpy()[..., : int(n)], _GOLDENS[f"{key}/0"], atol=1e-9)
    assert json.loads((DATA / "transform_goldens.json").read_text())["keys"]


def _golden_coeffs(key: str) -> list:
    out, i = [], 0
    while f"{key}/{i}" in _GOLDENS:
        out.append(_GOLDENS[f"{key}/{i}"])
        i += 1
    return out


@pytest.mark.parametrize("mode", ["periodic", "periodization", "symmetric"])
def test_cross_package_round_trips(mode):
    x = np.random.RandomState(10).randn(3, 130)
    jcoeffs = jptwt.wavedec(jnp.asarray(x), "db3", mode=mode, level=3)
    rec = tptwt.waverec(coeffs_from_numpy([np.asarray(c) for c in jcoeffs], "cpu"), "db3", mode=_rec_mode(mode))
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-10, rtol=0)
    back = coeffs_to_numpy(tptwt.wavedec(torch.from_numpy(x), "db3", mode=mode, level=3))
    jrec = jptwt.waverec([jnp.asarray(c) for c in back], "db3", mode=_rec_mode(mode))
    np.testing.assert_allclose(np.asarray(jrec), x, atol=1e-10, rtol=0)


@pytest.mark.parametrize("mode", ["periodization", "reflect"])
def test_waverec_rejects_mismatched_band(mode):
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 64))
    coeffs = tptwt.wavedec(x, "db2", mode=mode, level=2)
    coeffs[1] = coeffs[1][..., :-1]
    with pytest.raises(ValueError):
        tptwt.waverec(coeffs, "db2", mode=mode)


def _odd_bank():
    """A user's 7-tap bank (no registry wavelet has an odd length)."""
    rs = np.random.RandomState(70)
    return tuple(rs.randn(7) for _ in range(4))


# (shape, mode, level): the K6 periodization pyramid's and the K7/K8 long
# lanes' inputs; their gates decline an odd bank, so the levels run K3/K4
ODD_BANK_1D = [
    ((1, 64), "periodization", 2),
    ((3, 64), "periodization", 1),
    ((2, 70000), "reflect", 2),
    ((2, 70000), "periodic", 1),
    ((2, 70000), "zero", 3),
]


@pytest.mark.parametrize("shape,mode,level", ODD_BANK_1D)
def test_odd_bank_takes_the_per_level_route(model_kernels, shape, mode, level):  # noqa: F811
    """The CUDA glue on the numpy kernel model gives ``ptwt_tpu``'s band
    lengths and values for an odd bank (31 and 15 on 64 samples in
    periodization), and the round trip too, launching K3/K4 only."""
    bank = _odd_bank()
    assert not t6.fused_wavedec_applicable(shape[-1], 7, level)
    assert not t8._long_lane(shape[-1], 7)
    assert t8._long_lane(shape[-1], 8) == (shape[-1] > t8.FLAT_MIN_LANES)
    x = np.random.RandomState(71).randn(*shape)
    want = jptwt.wavedec(jnp.asarray(x), bank, mode=mode, level=level)
    got = tptwt.wavedec(torch.from_numpy(x), bank, mode=mode, level=level)
    _assert_coeffs(got, want, 1e-10)
    ran = _same_reconstruction(
        lambda: tptwt.waverec(got, bank, mode=_rec_mode(mode)),
        lambda: jptwt.waverec(want, bank, mode=_rec_mode(mode)),
    )
    assert {k for k, v in model_kernels.items() if v} == ({"K3", "K4"} if ran else {"K3"})


def _same_reconstruction(port, reference):
    """Both give the same array (True), or both refuse the chain (False):
    ``ptwt_tpu`` raises on most multi-level chains of an odd bank, whose
    band lengths do not match the crops it infers."""
    try:
        want = np.asarray(reference())
    except AssertionError:
        with pytest.raises(AssertionError, match="padding error"):
            port()
        return False
    got = port()
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    return True


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", MODES)
def test_empty_batch_matches_jax(mode, dtype):
    """``[0, 64]`` gives empty bands and round-trips to an empty array of
    the input's shape, as ``ptwt_tpu`` does."""
    x = np.zeros((0, 64), dtype=dtype)
    _round_trip(x, "db2", mode, 2, TOL[dtype])
    assert tuple(tptwt.waverec(tptwt.wavedec(torch.from_numpy(x), "db2", mode=mode, level=2), "db2",
                               mode=_rec_mode(mode)).shape) == x.shape


@pytest.mark.parametrize("mode,n,level", [("reflect", 70000, 6), ("periodization", 64, 2), ("zero", 64, 2)])
def test_empty_batch_on_the_kernel_glue(model_kernels, mode, n, level):  # noqa: F811
    """The CUDA glue (on the numpy kernel model) takes an empty batch on
    every route: the fused K8 run and K3/K4 levels of ``[0, 70000]``, the
    K6 pyramid and the per-level route; the wrappers launch nothing.  The
    bands have ``ptwt_tpu``'s shapes, and the reconstruction the input's
    (``ptwt_tpu.waverec`` itself stops with ``ZeroDivisionError`` on the
    ``[0, 70000]`` bands, in its slices synthesis).
    """
    x = np.zeros((0, n))
    want = jptwt.wavedec(jnp.asarray(x), "db4", mode=mode, level=level)
    got = tptwt.wavedec(torch.from_numpy(x), "db4", mode=mode, level=level)
    _assert_coeffs(got, want, 1e-12)
    assert tuple(tptwt.waverec(got, "db4", mode=_rec_mode(mode)).shape) == x.shape
    assert not any(model_kernels.values())


def _same_outcome(port, reference):
    """``ptwt_tpu`` and the port raise the same exception type, or give
    arrays of the same shape and values."""
    try:
        want = reference()
    except Exception as err:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(err)):
            port()
        return None
    got = port()
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert [tuple(g.shape) for g in got] == [np.asarray(w).shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10, rtol=0)
    return got


def _odd_bank_of(taps: int):
    rs = np.random.RandomState(72)
    return tuple(rs.randn(taps) for _ in range(4))


@pytest.mark.parametrize("route", ["plain", "glue"])
@pytest.mark.parametrize(
    "shape,taps,level,rec",
    [
        ((1, 4), 3, 3, False),  # level 3's input is empty: ValueError
        ((1, 6), 3, 4, False),  # level 4's
        ((1, 1), 9, 1, True),  # the [1, 0] bands reconstruct to [1, 0]
        ((1, 2), 5, 1, True),
    ],
)
def test_odd_bank_empty_chain_matches_jax(request, route, shape, taps, level, rec):
    """An odd-length bank's periodization chain whose bands run empty:
    ``wavedec`` raises ``ValueError`` where ``ptwt_tpu`` does, and
    ``waverec`` of the empty bands gives ``ptwt_tpu``'s shape."""
    if route == "glue":
        request.getfixturevalue("model_kernels")
    bank = _odd_bank_of(taps)
    x = np.random.RandomState(73).randn(*shape)
    got = _same_outcome(
        lambda: tptwt.wavedec(torch.from_numpy(x), bank, mode="periodization", level=level),
        lambda: jptwt.wavedec(jnp.asarray(x), bank, mode="periodization", level=level),
    )
    assert (got is not None) == rec
    if rec:
        want = jptwt.wavedec(jnp.asarray(x), bank, mode="periodization", level=level)
        out = _same_outcome(
            lambda: tptwt.waverec(got, bank, mode="periodization"),
            lambda: jptwt.waverec(want, bank, mode="periodization"),
        )
        assert tuple(out[0].shape) == (1, 0)


def test_wavedec_rejects_bad_input():
    with pytest.raises(ValueError, match="dtype"):
        tptwt.wavedec(torch.zeros(16, dtype=torch.float16), "haar")
    with pytest.raises(ValueError):
        tptwt.wavedec(torch.zeros(()), "haar")


def test_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    x = np.zeros(16, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.wavedec(x, "haar")
    with pytest.raises(RuntimeError, match="CUDA"):
        tptwt.waverec([x, x], "haar")


def test_plain_path_carries_gradients():
    """On the CPU every route is autograd-transparent, filters included."""
    w = tptwt.RegistryWavelet("db2")
    bank = [torch.tensor(f, dtype=torch.float64, requires_grad=True) for f in w.filter_bank]
    x = torch.randn(1, 40, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_()

    def loss(inp, *filters):
        coeffs = tptwt.wavedec(inp, tuple(filters), mode="reflect", level=2)
        return (tptwt.waverec(coeffs, tuple(filters)) ** 2).sum() + sum((c**2).sum() for c in coeffs)

    assert torch.autograd.gradcheck(loss, (x, *bank))


def test_docstring_examples():
    import doctest
    import importlib

    mod = importlib.import_module("ptwt_tpu_torch.conv_transform")
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0 and result.failed == 0
