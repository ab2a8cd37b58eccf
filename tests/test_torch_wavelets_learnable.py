"""Learnable filter banks of ptwt_tpu_torch against the JAX package.

The banks' losses and return tuples are held against
``ptwt_tpu.wavelets_learnable`` in float64 within 1e-12, and the filter
gradients through the public transforms against ``jax.grad`` through
``ptwt_tpu`` (float64 within 1e-10 relative, float32 within 1e-4 of the
largest entry), on the CPU's plain path and on the CUDA glue run against
the numpy model of the kernels (``model_kernels`` of
``tests/test_torch_kernels.py``, whose KT entry sums the taps' products
from the extended input as K3 reads it).  There a bank that requires grad
launches only K3, K4 and KT, and under ``torch.no_grad()`` the routes are
a constant bank's.  KT's plain versions are held against the model's KT
in every mode, axis, pair count and an odd-length bank.
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
from ptwt_tpu.wavelets import Wavelet as JWavelet
from ptwt_tpu.wavelets_learnable import ProductFilter as JProductFilter
from ptwt_tpu.wavelets_learnable import SoftOrthogonalWavelet as JSoftOrthogonalWavelet
from ptwt_tpu.wavelets_learnable import WaveletFilter as JWaveletFilter
from ptwt_tpu_torch import wavelets_learnable as tl
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d
from _torch_one_thread import one_torch_thread  # noqa: F401

CLASSES = {
    "WaveletFilter": (tl.WaveletFilter, JWaveletFilter),
    "ProductFilter": (tl.ProductFilter, JProductFilter),
    "SoftOrthogonalWavelet": (tl.SoftOrthogonalWavelet, JSoftOrthogonalWavelet),
}
PRODUCT_LOSSES = (
    "pf_alias_cancellation_loss",
    "alias_cancellation_loss",
    "perfect_reconstruction_loss",
    "product_filter_loss",
    "wavelet_loss",
)
SOFT_LOSSES = ("rec_lo_orthogonality_loss", "filt_bank_orthogonality_loss")
MODES = ["zero", "reflect", "periodic", "symmetric", "constant", "periodization"]
FIELDS = ("dec_lo", "dec_hi", "rec_lo", "rec_hi")


def _arrays(source, dtype=np.float64):
    """A bank's four filters as numpy: a registry wavelet, a perturbed one
    (``name+``, generic gradients), or random (``random<L>``)."""
    rng = np.random.RandomState(7)
    if source.startswith("random"):
        length = int(source[len("random"):])
        return [rng.randn(length).astype(dtype) for _ in range(4)]
    bank = [np.asarray(f, dtype=np.float64) for f in JWavelet(source.rstrip("+")).filter_bank]
    if source.endswith("+"):
        bank = [f + 0.1 * rng.randn(len(f)) for f in bank]
    return [f.astype(dtype) for f in bank]


def _banks(source, dtype=np.float64, cls="SoftOrthogonalWavelet"):
    tcls, jcls = CLASSES[cls]
    arrays = _arrays(source, dtype)
    return tl.bank_from_numpy(arrays, cls=tcls), jcls(*(jnp.asarray(f) for f in arrays))


def _as_list(value):
    return list(value) if isinstance(value, tuple) else [value]


# ---------------------------------------------------------------------------
# the banks and their losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", list(CLASSES))
@pytest.mark.parametrize("source", ["haar", "db3", "sym4", "bior2.2", "random6", "random7"])
def test_losses_match_jax(cls, source):
    bank, jbank = _banks(source, cls=cls)
    names = PRODUCT_LOSSES + (SOFT_LOSSES if cls == "SoftOrthogonalWavelet" else ())
    for name in names:
        got = _as_list(getattr(bank, name)())
        want = _as_list(getattr(jbank, name)())
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and tuple(g.shape) == np.shape(w), name
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-12, rtol=0, err_msg=name)
    assert len(bank) == len(jbank)
    for g, w in zip(bank.filter_bank, jbank.filter_bank):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


@pytest.mark.parametrize("source", ["db3+", "random7"])
def test_loss_gradients_match_jax(source):
    bank, jbank = _banks(source)
    bank.wavelet_loss().backward()
    want = jax.grad(lambda b: b.wavelet_loss() + b.rec_lo_orthogonality_loss())(jbank)
    bank.rec_lo_orthogonality_loss().backward()
    for name in FIELDS:
        np.testing.assert_allclose(getattr(bank, name).grad.numpy(), np.asarray(getattr(want, name)), atol=1e-12)


def test_module_idiom_and_from_wavelet():
    bank = tl.SoftOrthogonalWavelet.from_wavelet("db4", dtype=torch.float32)
    params = list(bank.parameters())
    assert len(params) == 4 and all(isinstance(p, torch.nn.Parameter) for p in params)
    assert all(a is b for a, b in zip(bank.filter_bank, params))
    assert len(bank) == 8 and bank.dec_lo.dtype == torch.float32
    want = JSoftOrthogonalWavelet.from_wavelet("db4")
    for g, w in zip(bank.filter_bank, want.filter_bank):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-7)
    assert tl.__all__ == ["WaveletFilter", "ProductFilter", "SoftOrthogonalWavelet"]


def test_bank_from_numpy():
    arrays = _arrays("db3+")
    jbank = JSoftOrthogonalWavelet(*(jnp.asarray(f) for f in arrays))
    for given in (jbank, tuple(arrays), arrays):
        bank = tl.bank_from_numpy(given)
        assert type(bank) is tl.SoftOrthogonalWavelet
        for g, w in zip(bank.filter_bank, arrays):
            np.testing.assert_array_equal(g.detach().numpy(), w)
    single = tl.bank_from_numpy([f.astype(np.float32) for f in arrays], cls=tl.ProductFilter)
    assert type(single) is tl.ProductFilter and single.dec_lo.dtype == torch.float32
    copied = tl.bank_from_numpy(arrays)
    arrays[0][0] = 123.0  # the bank holds copies
    assert float(copied.dec_lo.detach()[0]) != 123.0
    with pytest.raises(ValueError, match="four filters"):
        tl.bank_from_numpy(arrays[:3])


def test_training_recovers_wavelet_properties():
    """``tests/test_wavelets_learnable.py``'s 500 gradient steps, in torch:
    the first gradient is ``jax.grad``'s, the loss falls 1000-fold and the
    trained bank reconstructs through the transforms."""
    rng = np.random.RandomState(1)
    arrays = [np.asarray(f) + 0.1 * rng.randn(4) for f in JWavelet("db2").filter_bank]
    bank = tl.bank_from_numpy(arrays)
    want = jax.grad(lambda b: b.wavelet_loss())(JSoftOrthogonalWavelet(*(jnp.asarray(f) for f in arrays)))
    loss0 = bank.wavelet_loss()
    first = torch.autograd.grad(loss0, list(bank.parameters()))
    for g, name in zip(first, FIELDS):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), atol=1e-12)
    opt = torch.optim.SGD(bank.parameters(), lr=0.1)
    for _ in range(500):
        opt.zero_grad()
        bank.wavelet_loss().backward()
        opt.step()
    assert float(bank.wavelet_loss()) < float(loss0) * 1e-3
    x = torch.from_numpy(rng.randn(64))
    with torch.no_grad():
        rec = tptwt.waverec(tptwt.wavedec(x, bank.filter_bank, mode="zero", level=2), bank.filter_bank)
    assert float((rec - x).abs().max()) < 0.05


# ---------------------------------------------------------------------------
# filter gradients through the transforms against jax.grad
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _weighted(leaves, xp) -> object:
    """A loss that weighs every output differently: ``sum (1 + k/10) c^2``
    over leaf ``k`` plus ``sum sin(c)``."""
    return sum((1.0 + 0.1 * k) * xp.sum(c * c) + xp.sum(xp.sin(c)) for k, c in enumerate(leaves))


def _run_1d(lib, x, filt, mode, level):
    coeffs = lib.wavedec(x, filt, mode=mode, level=level)
    return list(coeffs) + [lib.waverec(coeffs, filt, mode=mode)]


def _run_2d(lib, x, filt, mode, level):
    coeffs = lib.wavedec2(x, filt, mode=mode, level=level)
    return _leaves(coeffs) + [lib.waverec2(coeffs, filt, mode=mode)]


def _run_3d(lib, x, filt, mode, level):
    coeffs = lib.wavedec3(x, filt, mode=mode, level=level)
    return _leaves(coeffs) + [lib.waverec3(coeffs, filt, mode=mode)]


def _run_fs2(lib, x, filt, mode, level):
    coeffs = lib.fswavedec2(x, filt, mode=mode, level=level)
    return _leaves(coeffs) + [lib.fswaverec2(coeffs, filt)]


def _run_packet(lib, x, filt, mode, level):
    tree = lib.WaveletPacket2D(x, filt, mode=mode, maxlevel=level)
    return [tree[k] for k in tptwt.WaveletPacket2D.get_level(level, "natural")]


RUNS = {"1d": _run_1d, "2d": _run_2d, "3d": _run_3d, "fs2": _run_fs2, "packet": _run_packet}


def _torch_grads(kind, x, source, mode, level, dtype=np.float64):
    """The port's gradients of the weighted loss with respect to the four
    filters (zeros for filters the run does not use), and the launches."""
    bank, _ = _banks(source, dtype)
    _kernels.reset_launch_counts()
    loss = _weighted(RUNS[kind](tptwt, torch.from_numpy(x), bank.filter_bank, mode, level), torch)
    got = torch.autograd.grad(loss, list(bank.parameters()), allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, bank.parameters())]
    return got, {k: v for k, v in _kernels.LAUNCHES.items() if v}


def _jax_grads(kind, x, source, mode, level, dtype=np.float64) -> list:
    _, jbank = _banks(source, dtype)
    run = RUNS[kind]
    want = jax.grad(lambda b: _weighted(run(jptwt, jnp.asarray(x), b.filter_bank, mode, level), jnp))(jbank)
    return [np.asarray(getattr(want, f)) for f in FIELDS]


def _check_grads(got, want, dtype):
    want = [np.asarray(w) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)) / scale
    assert err <= (1e-10 if dtype == np.float64 else 1e-4), err


CASES = [
    *[("1d", (2, n), "db3+", mode, 2, np.float64) for mode in MODES for n in (33, 40)],
    ("1d", (1, 40), "random6", "reflect", 2, np.float64),
    # an odd-length bank: periodization gives period / 2 - 1 bands
    ("1d", (1, 48), "random7", "periodization", 1, np.float64),
    ("1d", (2, 40), "db3+", "reflect", 2, np.float32),
    *[("2d", (2, 20, 17), "db2+", mode, 2, np.float64) for mode in ("periodic", "reflect")],
    ("3d", (1, 9, 10, 11), "db2+", "reflect", 1, np.float64),
    ("fs2", (2, 12, 13), "db2+", "zero", 1, np.float64),
    ("packet", (1, 16, 18), "db2+", "reflect", 1, np.float64),
]


@pytest.mark.parametrize("kind,shape,source,mode,level,dtype", CASES)
def test_filter_grads_match_jax(kind, shape, source, mode, level, dtype):
    x = np.random.RandomState(3).randn(*shape).astype(dtype)
    got, _ = _torch_grads(kind, x, source, mode, level, dtype)
    _check_grads(got, _jax_grads(kind, x, source, mode, level, dtype), dtype)


#: (kind, shape, mode, level, the launches of a constant bank's round trip
#: with torch.no_grad(): the fused routes a learnable bank declines)
GLUE = [
    ("1d", (1, 70001), "reflect", 3, {"K8a": 1, "K8b": 1}),
    ("1d", (2, 2**11), "periodization", 3, {"K6a": 1, "K6b": 1}),
    ("2d", (1, 38, 42), "periodic", 2, {"K1": 2, "K2": 2}),
    ("2d", (1, 32, 32), "periodization", 2, {"K5a": 1, "K5b": 1}),
    ("3d", (1, 9, 10, 11), "zero", 1, {"K3": 3, "K4": 4}),
]


@pytest.mark.parametrize("kind,shape,mode,level,fused", GLUE)
def test_glue_learnable_bank_takes_k3_k4(model_kernels, kind, shape, mode, level, fused, monkeypatch):  # noqa: F811
    """On the CUDA glue (the kernel model), against the plain path."""
    x = np.random.RandomState(5).randn(*shape)
    got, launched = _torch_grads(kind, x, "db2+", mode, level)
    with monkeypatch.context() as plain:
        for module in (t2, t2d, t6, t7, t8):
            plain.setattr(module, "_on_cpu", lambda t: True)
        want, _ = _torch_grads(kind, x, "db2+", mode, level)
    _check_grads(got, want, np.float64)
    # each forward launch has one KT launch and one VJP launch of its twin,
    # but for the first analysis launch's: the input requires no grad
    assert set(launched) == {"K3", "K4", "KT"}
    assert launched["KT"] == launched["K3"] == launched["K4"] + 1
    bank, _ = _banks("db2+")
    with torch.no_grad():
        _kernels.reset_launch_counts()
        RUNS[kind](tptwt, torch.from_numpy(x), bank.filter_bank, mode, level)
        learn_nograd = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        _kernels.reset_launch_counts()
        RUNS[kind](tptwt, torch.from_numpy(x), tuple(_arrays("db2+")), mode, level)
    assert learn_nograd == {k: v for k, v in _kernels.LAUNCHES.items() if v} == fused


@pytest.mark.parametrize("kind,shape", [("1d", (0, 32)), ("2d", (0, 12, 10))])
def test_empty_batch_gives_zero_filter_grads(model_kernels, kind, shape):  # noqa: F811
    """``ptwt_tpu`` cannot reshape an empty batch (a modulo by zero); the
    port gives zero filter gradients, with no KT launch on the card."""
    got, launched = _torch_grads(kind, np.zeros(shape), "db2+", "reflect", 2)
    assert [g.shape for g in got] == [(4,)] * 4 and not any(g.abs().max() for g in got)
    assert "KT" not in launched and "K3" not in launched


def test_double_backward_raises(model_kernels, monkeypatch):  # noqa: F811
    """A second backward through K3/K4 and KT (KT's VJP on K3/K4, the fold
    instance's filter gradient on KT) meets the plain path's."""
    bank, _ = _banks("db2+")
    x = torch.randn(1, 24, dtype=torch.float64, requires_grad=True)
    params = [x, *bank.parameters()]

    def second():
        loss = _weighted(_run_1d(tptwt, x, bank.filter_bank, "reflect", 2), torch)
        grads = torch.autograd.grad(loss, [x, bank.dec_lo], create_graph=True)
        return torch.autograd.grad((grads[0] ** 2).sum() + grads[1].sum(), params)

    _kernels.reset_launch_counts()
    got = second()
    assert {k for k, v in model_kernels.items() if v} == {"K3", "K4", "KT"}
    with monkeypatch.context() as plain:
        for module in (t2, t2d, t6, t7, t8):
            plain.setattr(module, "_on_cpu", lambda t: True)
        want = second()
    _check_grads(got, [w.detach().numpy() for w in want], np.float64)


def test_matrix_transforms_refuse_learnable_banks():
    """``ptwt_tpu`` builds the boundary operators with ``np.asarray`` and
    refuses a traced bank with a TypeError; so does the port, with no
    silent detach."""
    bank, jbank = _banks("db2+")
    with pytest.raises(TypeError, match="no filter gradient"):
        tptwt.MatrixWavedec(bank, 2)

    class Traced:  # a registry-like wavelet around the traced filters
        def __init__(self, b):
            self.filter_bank, self.dec_len, self.rec_len, self.name = b.filter_bank, len(b), len(b), "traced"

    with pytest.raises(TypeError):
        jax.grad(lambda b: jnp.sum(jptwt.MatrixWavedec(Traced(b), 2)(jnp.ones((1, 32)))[0]))(jbank)
    for cls in (tptwt.MatrixWaverec, tptwt.MatrixWavedec2, tptwt.MatrixWaverec3):
        with pytest.raises(TypeError, match="no filter gradient"):
            cls(bank)


# ---------------------------------------------------------------------------
# KT's plain versions against the kernel model
# ---------------------------------------------------------------------------


AXIS_MODES = ["zero", "constant", "symmetric", "reflect", "periodic", "periodization", "valid"]


@pytest.mark.parametrize("mode", AXIS_MODES)
@pytest.mark.parametrize("axis,shape", [(-1, (2, 3, 11)), (-2, (2, 12, 5)), (-3, (9, 2, 3))])
@pytest.mark.parametrize("taps", [6, 7])
def test_tap_grad_plain_matches_kernel_model(model_kernels, mode, axis, shape, taps):  # noqa: F811
    rng = np.random.RandomState(taps)
    x = torch.from_numpy(rng.randn(*shape))
    dl, dh, rl, rh = (rng.randn(taps) for _ in range(4))
    ax = axis % x.ndim
    m, period, pad, code = t2._analysis_plan(x.shape[ax], taps, mode)
    ct = torch.from_numpy(rng.randn(2, *[m if i == ax else s for i, s in enumerate(shape)]))
    got = t2._tap_grad_kernel(x, ax, [ct[0]], [ct[1]], taps, period, pad, code)
    want = t2.dwt_axis_tap_grad_plain(x, axis, dl, dh, mode, ct)
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), atol=1e-12)
    if mode == "valid":
        return
    # K4's taps, one and two pairs, the standard crop (periodization: none)
    p = 0 if mode == "periodization" else (2 * taps - 3) // 2
    for groups in (1, 2):
        los = [torch.from_numpy(rng.randn(*ct.shape[1:])) for _ in range(groups)]
        his = [torch.from_numpy(rng.randn(*ct.shape[1:])) for _ in range(groups)]
        out = t2.pallas_idwt_axis(los, his, axis, rl, rh, p, p, mode)
        cot = torch.from_numpy(rng.randn(*out.shape))
        circular = mode == "periodization"
        per, c = (2 * m, t2._WRAP_ZERO) if circular else (out.shape[ax + 1], t2._ZERO)
        off = p + taps // 2 - 1 if circular else p
        got = t2._tap_grad_kernel(cot, ax + 1, los, his, taps, per, off, c)
        want = t2.idwt_axis_tap_grad_plain(los, his, axis, rl, rh, p, p, mode, cot)
        np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), atol=1e-12)
