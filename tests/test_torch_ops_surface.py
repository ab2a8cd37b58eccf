"""The rest of ``ptwt_tpu_torch.ops``, ``utils`` and ``constants`` against
``ptwt_tpu`` on the CPU.

The public lists are pinned against the JAX package's; the dense operator
builders (``analysis_matrix``/``synthesis_matrix``) against JAX's numpy
arrays within 1e-15; the filter-bank convolutions and
``construct_nd_filter`` within 1e-12 (float64) and 1e-5 (float32); and the
public ``dwt_axis``/``idwt_axis`` against JAX's on axes 0, 1 and -1 in
every mode, including the uncropped synthesis (``padl = padr = 0``).
"""

from __future__ import annotations

import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptwt_tpu.constants as jconstants
import ptwt_tpu.ops as jops
import ptwt_tpu.utils as jutils
import ptwt_tpu_torch as tptwt
import ptwt_tpu_torch.constants as tconstants
import ptwt_tpu_torch.ops as tops
import ptwt_tpu_torch.utils as tutils
from ptwt_tpu_torch.utils import get_filter_arrays
from _torch_one_thread import one_torch_thread  # noqa: F401

MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _banks(wavelet, dtype=np.float64):
    """Flipped analysis and unflipped synthesis pairs as numpy arrays."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=tdtype)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=tdtype)
    return dl, dh, rl, rh


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the public lists
# ---------------------------------------------------------------------------


def test_ops_names_match_jax():
    """``ptwt_tpu_torch.ops`` exports ``ptwt_tpu.ops``'s list, in its order."""
    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name))


def test_utils_names_match_jax():
    """``utils.__all__`` is the JAX package's list in its order, then the
    port's own names (the numpy container helpers and the subband table)."""
    assert tutils.__all__[: len(jutils.__all__)] == jutils.__all__
    assert tutils.__all__[len(jutils.__all__) :] == [
        "SUBBAND_ORDERS", "as_device_tensor", "coeffs_from_numpy", "coeffs_to_numpy",
    ]
    for name in tutils.__all__:
        assert getattr(tutils, name) is not None


def test_constants_names_match_jax():
    assert tconstants.__all__ == jconstants.__all__
    assert typing.get_args(tconstants.PaddingMode) == typing.get_args(jconstants.PaddingMode)


def test_invalid_coeffs_message_matches_jax():
    for kind, got in (("3-tuple of arrays", [1]), ("dict containing 7 arrays", (1,))):
        assert tutils.invalid_coeffs_message(kind, got) == jutils.invalid_coeffs_message(kind, got)


@pytest.mark.parametrize(
    "call",
    [
        lambda: tptwt.waverec2([torch.zeros(1, 4, 4), [torch.zeros(1, 4, 4)] * 3], "haar"),
        lambda: tptwt.waverec3([torch.zeros(1, 4, 4, 4), (torch.zeros(1, 4, 4, 4),)], "haar"),
        lambda: tptwt.MatrixWaverec2("haar")([torch.zeros(1, 4, 4), [torch.zeros(1, 4, 4)] * 3]),
        lambda: tptwt.MatrixWaverec3("haar")([torch.zeros(1, 4, 4, 4), (torch.zeros(1, 4, 4, 4),)]),
    ],
    ids=["waverec2", "waverec3", "MatrixWaverec2", "MatrixWaverec3"],
)
def test_malformed_containers_use_the_shared_message(call):
    with pytest.raises(ValueError, match="Unexpected detail coefficient type: .* as returned by the decomposition"):
        call()


# ---------------------------------------------------------------------------
# the dense operators
# ---------------------------------------------------------------------------

# banks of 2, 6, 8, 10 and 34 taps; the long one on axes shorter than it
BANKS = ["haar", "bior2.2", "db4", "sym5", "db17"]
LENGTHS = [1, 2, 5, 8, 37, 64]


@pytest.mark.parametrize("wavelet", BANKS)
@pytest.mark.parametrize("mode", [*MODES, "valid"])
def test_analysis_matrix_matches_jax(wavelet, mode):
    dl, dh, _, _ = _banks(wavelet)
    for n in LENGTHS:
        if mode == "valid" and n < len(dl):
            continue
        got = tops.analysis_matrix(n, dl, dh, mode)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        _close(got, jops.analysis_matrix(n, dl, dh, mode), 1e-15)


@pytest.mark.parametrize("wavelet", BANKS)
@pytest.mark.parametrize("periodization", [False, True])
def test_synthesis_matrix_matches_jax(wavelet, periodization):
    _, _, rl, rh = _banks(wavelet)
    p = len(rl) // 2 - 1 if periodization else (2 * len(rl) - 3) // 2
    for m in (1, 3, 10, 33):
        for padl, padr in ((0, 0), (1, 2), (p, p)):
            if periodization and padl + padr > 2 * m:
                continue
            got = tops.synthesis_matrix(m, rl, rh, padl, padr, periodization)
            assert got.dtype == torch.float64 and got.device.type == "cpu"
            _close(got, jops.synthesis_matrix(m, rl, rh, padl, padr, periodization), 1e-15)


def test_operators_take_tensor_taps():
    dl, dh, rl, rh = _banks("db3")
    want = tops.analysis_matrix(21, dl, dh, "reflect")
    got = tops.analysis_matrix(21, torch.from_numpy(dl.copy()), torch.from_numpy(dh.copy()), "reflect")
    assert torch.equal(got, want)
    got = tops.synthesis_matrix(11, torch.from_numpy(rl.copy()), rh.tolist(), 4, 4)
    assert torch.equal(got, tops.synthesis_matrix(11, rl, rh, 4, 4))


def test_matmul_max_length_knob():
    assert tops.get_matmul_max_length() == jops.get_matmul_max_length() == 2048
    tops.set_matmul_max_length(100)
    try:
        assert tops.get_matmul_max_length() == 100
    finally:
        tops.set_matmul_max_length(2048)


# ---------------------------------------------------------------------------
# the filter-bank convolutions
# ---------------------------------------------------------------------------

CONV_SHAPES = {1: (3, 21), 2: (2, 12, 15), 3: (2, 9, 8, 11)}


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("wavelet", ["haar", "db3"])
def test_construct_nd_filter_matches_jax(ndim, dtype, wavelet):
    dl, dh, rl, rh = _banks(wavelet, dtype)
    for lo, hi in ((dl, dh), (rl, rh)):
        want = jutils.construct_nd_filter(jnp.asarray(lo), jnp.asarray(hi), ndim)
        got = tutils.construct_nd_filter(torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy()), ndim)
        assert got.dtype == torch.from_numpy(lo).dtype
        _close(got, want, TOL[dtype])
        _close(tutils.construct_nd_filter(lo, hi, ndim), want, TOL[dtype])


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("wavelet", ["haar", "db3", "sym4"])
def test_analysis_and_synthesis_conv_match_jax(ndim, dtype, wavelet):
    dl, dh, rl, rh = _banks(wavelet, dtype)
    rng = np.random.RandomState(ndim)
    data = rng.randn(*CONV_SHAPES[ndim]).astype(dtype)
    dec = tutils.construct_nd_filter(dl, dh, ndim)
    rec = tutils.construct_nd_filter(rl, rh, ndim)
    jdec = jutils.construct_nd_filter(jnp.asarray(dl), jnp.asarray(dh), ndim)
    jrec = jutils.construct_nd_filter(jnp.asarray(rl), jnp.asarray(rh), ndim)
    got = tops.analysis_conv(torch.from_numpy(data), dec)
    want = jops.analysis_conv(jnp.asarray(data), jdec)
    _close(got, want, TOL[dtype])
    coeffs = rng.randn(*got.shape).astype(dtype)
    _close(tops.synthesis_conv(torch.from_numpy(coeffs), rec), jops.synthesis_conv(jnp.asarray(coeffs), jrec),
           TOL[dtype])


def test_conv_restores_the_callers_tf32_flag(monkeypatch):
    """The convolutions set cuDNN's TF32 flag around themselves (off at
    ``"highest"``, and on the CPU at every level) and leave the caller's
    value in place."""
    seen = []
    conv2d, conv_transpose2d = tops._conv._CONVS[2]

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setitem(tops._conv._CONVS, 2, (spy, conv_transpose2d))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    filt = tutils.construct_nd_filter(*_banks("db2")[:2], 2)
    tops.analysis_conv(torch.zeros(1, 8, 8, dtype=torch.float64), filt)
    assert torch.backends.cudnn.allow_tf32 is True
    assert seen == [False]


def test_periodization_wrap_matches_jax():
    data = np.random.RandomState(5).randn(3, 2, 30)
    for filt_len in (2, 8, 20):
        for axis in (0, 2):
            moved = np.moveaxis(data, 2, axis)
            want = jops.periodization_wrap(jnp.asarray(moved), axis, filt_len)
            _close(tops.periodization_wrap(torch.from_numpy(moved), axis, filt_len), want, 1e-12)


# ---------------------------------------------------------------------------
# ops.dwt_axis / ops.idwt_axis on the JAX contract
# ---------------------------------------------------------------------------


def test_idwt_axis_takes_one_pair_along_axis_0():
    """The ``[40, 5, 3]`` case along axis 0 (db4 ``reflect``): one ``lo``
    and one ``hi`` in, the ``[40, 5, 3]`` signal out, as ``ptwt_tpu``
    gives it (the multi-pair form once read axis 0 as the pair index and
    returned ``[23, 4, 3]``)."""
    x = np.random.RandomState(0).randn(40, 5, 3)
    dl, dh, rl, rh = _banks("db4")
    jlo, jhi = jops.dwt_axis(jnp.asarray(x), 0, dl, dh, "reflect")
    lo, hi = tops.dwt_axis(torch.from_numpy(x), 0, dl, dh, "reflect")
    _close(lo, jlo, 1e-12)
    _close(hi, jhi, 1e-12)
    want = jops.idwt_axis(jlo, jhi, 0, rl, rh, 6, 6, "reflect")
    got = tops.idwt_axis(torch.from_numpy(np.array(jlo)), torch.from_numpy(np.array(jhi)), 0, rl, rh, 6, 6,
                         "reflect")
    assert tuple(got.shape) == (40, 5, 3) == want.shape
    _close(got, want, 1e-12)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dwt_axis_idwt_axis_match_jax(axis, mode, dtype):
    x = np.random.RandomState(1).randn(40, 5, 13).astype(dtype)
    dl, dh, rl, rh = _banks("db4", dtype)
    jlo, jhi = jops.dwt_axis(jnp.asarray(x), axis, dl, dh, mode)
    out = tops.dwt_axis(torch.from_numpy(x), axis, dl, dh, mode)
    assert isinstance(out, tuple) and len(out) == 2
    _close(out[0], jlo, TOL[dtype])
    _close(out[1], jhi, TOL[dtype])
    p = 0 if mode == "periodization" else (2 * len(rl) - 3) // 2
    lo, hi = (torch.from_numpy(np.array(b)) for b in (jlo, jhi))
    for padl, padr in {(p, p), (0, 0)}:
        want = jops.idwt_axis(jlo, jhi, axis, rl, rh, padl, padr, mode)
        _close(tops.idwt_axis(lo, hi, axis, rl, rh, padl, padr, mode), want, TOL[dtype])


def test_dwt_axis_valid_matches_jax():
    """``valid``: the caller padded beforehand."""
    x = np.random.RandomState(2).randn(3, 30)
    dl, dh, rl, rh = _banks("db3")
    jlo, jhi = jops.dwt_axis(jnp.asarray(x), -1, dl, dh, "valid")
    lo, hi = tops.dwt_axis(torch.from_numpy(x), -1, dl, dh, "valid")
    _close(lo, jlo, 1e-12)
    _close(hi, jhi, 1e-12)
    want = jops.idwt_axis(jlo, jhi, -1, rl, rh, 0, 0, "valid")
    _close(tops.idwt_axis(lo, hi, -1, rl, rh, 0, 0, "valid"), want, 1e-12)
