"""The CUDA kernels of ptwt_tpu_torch against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``ptwt_tpu``, so it also runs where only the
port is installed::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import ptwt_tpu_torch as tptwt  # noqa: E402
from _torch_banks import lattice_bank  # noqa: E402
from ptwt_tpu_torch.ops import _kernels  # noqa: E402
from ptwt_tpu_torch.ops import _mxu2d as t9  # noqa: E402
from ptwt_tpu_torch.ops import _pallas as t5  # noqa: E402
from ptwt_tpu_torch.ops import _pallas as t6  # noqa: E402
from ptwt_tpu_torch.ops import _pallas1d as t7  # noqa: E402
from ptwt_tpu_torch.ops import _pallas1d_multi as t8  # noqa: E402
from ptwt_tpu_torch.ops import _pallas2 as t2  # noqa: E402
from ptwt_tpu_torch.ops import _pallas2d as t2d  # noqa: E402
from ptwt_tpu_torch.utils import get_filter_arrays  # noqa: E402

AXIS_MODES = ["zero", "reflect", "periodic", "symmetric", "constant", "periodization", "valid"]


def _std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


def _banks(wavelet):
    dl, dh, _, _ = get_filter_arrays(wavelet, flip=True, dtype=torch.float64)
    _, _, rl, rh = get_filter_arrays(wavelet, flip=False, dtype=torch.float64)
    return dl, dh, rl, rh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# float32 runs db4/db3, the main path's lengths; float64 also runs the two
# ends of the registry, haar (2 taps) and coif17 (102 taps, whose reach
# wraps several periods of these small axes)
CASES = [(torch.float32, "db4"), (torch.float64, "db4"), (torch.float64, "haar"),
         (torch.float64, "coif17")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wavelet", CASES)
@pytest.mark.parametrize("mode", ["periodic", "periodization"])
def test_cuda_k1_k2_match_plain(cuda_device, dtype, wavelet, mode):
    dl, dh, rl, rh = _banks(wavelet)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    x = torch.randn(3, 64, 70, dtype=dtype, device=cuda_device)
    _kernels.reset_launch_counts()
    got = t2d.fused2_dwt_level(x, dl, dh, mode)
    want = t2d.dwt2_level_plain(x, dl, dh, mode)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= tol
    p = 0 if mode == "periodization" else _std_pad(len(dl))
    rec = t2d.fused2_idwt_level(want, rl, rh, mode)
    ref = t2d.idwt2_level_plain(want, rl, rh, mode, [(p, p)] * 2)
    assert float((rec - ref).abs().max()) <= tol
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K1"] == 1 and _kernels.LAUNCHES["K2"] == 1


# K3/K4 cases: every mode on the small odd image (db4 runs db3 there),
# coif17 (102 taps) also on a 9 x 10 image, whose reads wrap each axis
# about ten times, and the headline's reflect level 1 (db4 on
# [16, 1024, 1024] along H, the packed [2, 16, 515, 1024] along W, the
# two-pair K4 along W and the one-pair K4 along H with the (6, 6) crop)
SMALL = (2, 37, 41)
TINY = (3, 9, 10)
LEVEL1 = (16, 1024, 1024)
AXIS_CASES = [
    # valid mode needs a signal at least as long as the filter
    *[(d, w, m, SMALL) for d, w in CASES for m in AXIS_MODES if (w, m) != ("coif17", "valid")],
    *[(torch.float64, "coif17", m, TINY) for m in AXIS_MODES if m != "valid"],
    (torch.float32, "db4", "reflect", LEVEL1),
]


def _axis_case(wavelet, mode, shape, axis, device, dtype):
    """Banks, input and synthesis crop of one K3/K4 case: the level-1
    input is ``shape`` along H and the packed rows pass along W."""
    dl, dh, rl, rh = _banks("db3" if (wavelet, shape) == ("db4", SMALL) else wavelet)
    if shape == LEVEL1 and axis == -1:
        shape = (2, 16, 515, 1024)
    x = torch.randn(*shape, dtype=dtype, device=device)
    pad = 0 if mode in ("periodization", "valid") else len(dl) - 2
    return dl, dh, rl, rh, x, (pad, pad + shape[axis] % 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wavelet,mode,shape", AXIS_CASES)
@pytest.mark.parametrize("axis", [-2, -1])
def test_cuda_k3_k4_match_plain(cuda_device, dtype, wavelet, mode, shape, axis):
    dl, dh, rl, rh, x, crop = _axis_case(wavelet, mode, shape, axis, cuda_device, dtype)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    got = t2.pallas_dwt_axis(x, axis, dl, dh, mode)
    lo, hi = t2.dwt_axis_plain(x, axis, dl, dh, mode)
    assert float((got - torch.stack((lo, hi))).abs().max()) <= tol
    rec = t2.pallas_idwt_axis([lo, hi], [hi, lo], axis, rl, rh, *crop, mode)
    ref = [t2.idwt_axis_plain(a, b, axis, rl, rh, *crop, mode) for a, b in ((lo, hi), (hi, lo))]
    assert float((rec - torch.stack(ref)).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodic", "reflect", "periodization"])
def test_cuda_wavedec2_matches_cpu(cuda_device, mode):
    x = torch.randn(2, 67, 66, dtype=torch.float64)
    want = tptwt.wavedec2(x, "db4", mode=mode, level=3)
    got = tptwt.wavedec2(x.to(cuda_device), "db4", mode=mode, level=3)
    for g, w in zip([got[0]] + [b for t in got[1:] for b in t], [want[0]] + [b for t in want[1:] for b in t]):
        assert float((g.cpu() - w).abs().max()) <= 1e-12
    rec = tptwt.waverec2(got, "db4", mode=mode)
    assert float((rec.cpu()[..., :67, :66] - x).abs().max()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodic", "symmetric"])
def test_cuda_axes_and_batch_match_cpu(cuda_device, mode):
    """Non-default axes hand the kernels permuted, folded batches."""
    x = torch.randn(20, 3, 22, 2, dtype=torch.float64)
    want = tptwt.wavedec2(x, "sym4", mode=mode, level=2, axes=(0, 2))
    got = tptwt.wavedec2(x.to(cuda_device), "sym4", mode=mode, level=2, axes=(0, 2))
    for g, w in zip([got[0]] + [b for t in got[1:] for b in t], [want[0]] + [b for t in want[1:] for b in t]):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-12
    rec = tptwt.waverec2(got, "sym4", mode=mode, axes=(0, 2))
    assert float((rec.cpu() - tptwt.waverec2(want, "sym4", mode=mode, axes=(0, 2))).abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# the VJP kernels: K3 / K4 and K1 / K2, each pair each other's VJP
# ---------------------------------------------------------------------------


def _randn_like(t, seed):
    gen = torch.Generator(device=t.device).manual_seed(seed)
    return torch.randn(t.shape, generator=gen, dtype=t.dtype, device=t.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wavelet", CASES)
@pytest.mark.parametrize(
    "mode,shape",
    # odd periodization axes: K1's VJP folds the repeated last sample
    [("periodic", (3, 64, 70)), ("periodization", (3, 64, 70)), ("periodization", (3, 65, 71))],
)
def test_cuda_k1_k2_vjps_match_plain(cuda_device, dtype, wavelet, mode, shape):
    dl, dh, rl, rh = _banks(wavelet)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    x = torch.randn(*shape, dtype=dtype, device=cuda_device, requires_grad=True)
    bands = t2d.fused2_dwt_level(x, dl, dh, mode)
    cts = [_randn_like(b, i) for i, b in enumerate(bands)]
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(bands, x, cts)
    want = t2d.dwt2_level_vjp_plain(x, dl, dh, mode, cts)
    assert float((grad - want).abs().max()) <= tol
    assert _kernels.LAUNCHES["K2"] == 1
    p = 0 if mode == "periodization" else _std_pad(len(dl))
    if shape[-1] % 2:
        return  # K2 reconstructs even shapes only
    subbands = [b.detach().requires_grad_() for b in bands]
    rec = t2d.fused2_idwt_level(subbands, rl, rh, mode)
    ct = _randn_like(rec, 9)
    _kernels.reset_launch_counts()
    grads = torch.autograd.grad(rec, subbands, ct)
    want = t2d.idwt2_level_vjp_plain(subbands, rl, rh, mode, [(p, p)] * 2, ct)
    for g, w in zip(grads, want):
        assert float((g - w).abs().max()) <= tol
    assert _kernels.LAUNCHES["K1"] == 1


def _adjoint(outs, cts, ins, grads) -> float:
    """``|<K x, y> - <x, K^T y>|`` relative to ``|K x| |y|``."""
    outs, cts, ins, grads = ([t.detach() for t in ts] for ts in (outs, cts, ins, grads))
    lhs = sum(float((o * c).sum()) for o, c in zip(outs, cts))
    rhs = sum(float((i * g).sum()) for i, g in zip(ins, grads))
    scale = (sum(float((o**2).sum()) for o in outs) * sum(float((c**2).sum()) for c in cts)) ** 0.5
    return abs(lhs - rhs) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wavelet,mode,shape", AXIS_CASES)
@pytest.mark.parametrize("axis", [-2, -1])
def test_cuda_k3t_k4t_match_plain(cuda_device, dtype, wavelet, mode, shape, axis):
    """K3's VJP (K4's fold instance, one K4 launch) and K4's VJP (K3
    zero-bounded, one K3 launch) against autograd through the plain
    versions; in float64 the adjoint identity within 1e-12."""
    dl, dh, rl, rh, x, crop = _axis_case(wavelet, mode, shape, axis, cuda_device, dtype)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    x.requires_grad_()
    out = t2.pallas_dwt_axis(x, axis, dl, dh, mode)
    ct = _randn_like(out, 1)
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(out, x, ct)
    want = t2.dwt_axis_vjp_plain(x, axis, dl, dh, mode, ct)
    assert float((grad - want).abs().max()) <= tol
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K4": 1}
    if dtype == torch.float64:
        assert _adjoint([out], [ct], [x], [grad]) <= 1e-12
    lo, hi = (b.detach().requires_grad_() for b in out)
    rec = t2.pallas_idwt_axis([lo, hi], [hi, lo], axis, rl, rh, *crop, mode)
    ct = _randn_like(rec, 2)
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, (lo, hi), ct)
    want = [t2.idwt_axis_vjp_plain(a, b, axis, rl, rh, *crop, mode, c)
            for (a, b), c in zip(((lo, hi), (hi, lo)), ct)]
    # lo and hi each feed both groups, once as lo and once as hi
    assert float((got[0] - (want[0][0] + want[1][1])).abs().max()) <= 2 * tol
    assert float((got[1] - (want[0][1] + want[1][0])).abs().max()) <= 2 * tol
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K3": 1}
    if dtype == torch.float64:
        assert _adjoint([rec], [ct], [lo, hi], got) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,shape",
    [("periodic", (2, 66, 70)), ("reflect", (2, 67, 66)), ("periodization", (2, 67, 65))],
)
def test_cuda_public_gradients_match_cpu(cuda_device, mode, shape):
    x = torch.randn(*shape, dtype=torch.float64)
    weight = torch.randn(*shape, dtype=torch.float64)

    def grad_on(device):
        xd = x.to(device).requires_grad_()
        coeffs = tptwt.wavedec2(xd, "db4", mode=mode, level=3)
        rec = tptwt.waverec2(coeffs, "db4", mode=mode)[..., : shape[-2], : shape[-1]]
        loss = (rec * weight.to(device)).sum() + sum((b**2).sum() for t in coeffs[1:] for b in t)
        _kernels.reset_launch_counts()
        return torch.autograd.grad(loss, xd)[0]

    got = grad_on(cuda_device)
    torch.cuda.synchronize()
    # the backward of the per-axis levels: K3's VJPs are K4 launches, K4's K3
    assert _kernels.LAUNCHES["K3"] + _kernels.LAUNCHES["K4"] > 0
    assert float((got.cpu() - grad_on("cpu")).abs().max()) <= 1e-11


def _second_order(run, x: torch.Tensor, filt: torch.Tensor = None):
    """``d/d(x, filt)`` of the squared ``x`` gradient of the cubed outputs
    of ``run(x, filt)``: a second backward through every VJP of the run."""
    x = x.detach().requires_grad_()
    leaves = [x] if filt is None else [x, filt.detach().requires_grad_()]
    (grad,) = torch.autograd.grad((run(*leaves) ** 3).sum(), x, create_graph=True)
    return torch.autograd.grad((grad**2).sum(), leaves)


def _close_f64(got, want) -> None:
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-10 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_filter_grad_and_double_backward_raise(cuda_device):
    """K3's filter gradient (one KT launch) matches the CPU's, and so does
    a second backward through K3, K4's fold instance and KT (float64)."""
    x = torch.randn(1, 32, 32, dtype=torch.float64, device=cuda_device, requires_grad=True)
    dl, dh, _, _ = _banks("db2")

    def filter_grad(device):
        learn = torch.tensor(dl, device=device, requires_grad=True)
        out = t2.pallas_dwt_axis(x.detach().to(device), -1, learn, dh, "reflect")
        return torch.autograd.grad((out**2).sum(), learn)[0]

    _kernels.reset_launch_counts()
    got = filter_grad(cuda_device)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["KT"] == 1 and _kernels.LAUNCHES["K3"] == 1
    want = filter_grad("cpu")
    assert float((got.cpu() - want).abs().max()) <= 1e-10 * float(want.abs().max())

    def run(t, learn):
        return t2.pallas_dwt_axis(t, -1, learn, dh, "reflect")

    learn = torch.tensor(dl, dtype=torch.float64)
    _kernels.reset_launch_counts()
    got = _second_order(run, x, learn.to(cuda_device))
    torch.cuda.synchronize()
    assert {k for k, v in _kernels.LAUNCHES.items() if v} == {"K3", "K4", "KT"}
    _close_f64(got, _second_order(run, x.cpu(), learn))


# ---------------------------------------------------------------------------
# the 1d pyramid kernels: K6a/K6b, K7a/K7b, K8a/K8b
# ---------------------------------------------------------------------------


PADDED = ["zero", "reflect", "periodic", "symmetric", "constant"]


def _rel_err(got, want) -> float:
    """Max-abs difference over ``max(1, the band's largest magnitude)``."""
    if isinstance(got, (list, tuple)):
        return max(_rel_err(g, w) for g, w in zip(got, want))
    assert got.shape == want.shape
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _tol1d(dtype) -> float:
    return 2e-5 if dtype == torch.float32 else 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wavelet", ["db5", "haar", "coif17"])
@pytest.mark.parametrize("mode", PADDED)
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_cuda_k7_k8_match_plain(cuda_device, dtype, wavelet, mode, depth):
    dl, dh, rl, rh = _banks(wavelet)
    x = torch.randn(3, 70001, dtype=dtype, device=cuda_device)
    _kernels.reset_launch_counts()
    lo, his = t8.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
    ref_lo, ref_his = t8.multi_analysis_plain(x, dl, dh, mode, depth)
    assert _rel_err([lo, *his], [ref_lo, *ref_his]) <= _tol1d(dtype)
    # waverec's crops for this chain: each step ends as long as the finer band
    pads = [_std_pad(len(dl))] * depth
    lens = [x.shape[-1]] + [h.shape[-1] for h in ref_his[:-1]]
    coeffs = [ref_lo, *ref_his[::-1]]
    rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
    ref = t8.multi_synthesis_plain(coeffs, rl, rh, pads, lens)
    assert _rel_err(rec, ref) <= _tol1d(dtype)
    torch.cuda.synchronize()
    names = ("K7a", "K7b") if depth == 1 else ("K8a", "K8b")
    assert all(_kernels.LAUNCHES[k] == 1 for k in names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_k7_valid_and_odd_crop(cuda_device, dtype):
    dl, dh, rl, rh = _banks("db3")
    x = torch.randn(2, 3, 70010, dtype=dtype, device=cuda_device)
    got = t7.flat_dwt_lane(x, dl, dh, "valid")
    assert _rel_err(got, t2.dwt_axis_plain(x, -1, dl, dh, "valid")) <= _tol1d(dtype)
    lo, hi = got
    rec = t7.flat_idwt_lane(lo, hi, rl, rh, 4, 5)
    assert _rel_err(rec, t2.idwt_axis_plain(lo, hi, -1, rl, rh, 4, 5, "zero")) <= _tol1d(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wavelet", ["db5", "haar", "coif17"])
@pytest.mark.parametrize("n,level", [(2**14, 10), (3 * 2**10, 5), (2**12, 3), (64, 6)])
def test_cuda_k6_matches_plain(cuda_device, dtype, wavelet, n, level):
    dl, dh, rl, rh = _banks(wavelet)
    x = torch.randn(3, n, dtype=dtype, device=cuda_device)
    _kernels.reset_launch_counts()
    got = t6.fused_wavedec1d_per(x, dl, dh, level)
    want = t6.wavedec1d_per_plain(x, dl, dh, level)
    assert _rel_err(got, want) <= _tol1d(dtype)
    rec = t6.fused_waverec1d_per(want, rl, rh)
    assert _rel_err(rec, t6.waverec1d_per_plain(want, rl, rh)) <= _tol1d(dtype)
    assert _rel_err(rec, x) <= 10 * _tol1d(dtype)
    torch.cuda.synchronize()
    runs = -(-level // 4)
    assert _kernels.LAUNCHES["K6a"] == runs and _kernels.LAUNCHES["K6b"] == runs


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,n,level,used",
    [
        ("reflect", 70001, 6, {"K8a", "K8b", "K3", "K4"}),
        ("periodic", 1_000_000, 10, {"K8a", "K8b", "K3", "K4"}),
        ("symmetric", 70001, 1, {"K7a", "K7b"}),
        ("periodization", 2**17, 10, {"K6a", "K6b"}),
        ("periodization", 70001, 3, {"K3", "K4"}),
        ("zero", 65536, 3, {"K3", "K4"}),
    ],
)
def test_cuda_wavedec_matches_cpu(cuda_device, mode, n, level, used):
    x = torch.randn(2, n, dtype=torch.float64)
    want = tptwt.wavedec(x, "db5", mode=mode, level=level)
    _kernels.reset_launch_counts()
    got = tptwt.wavedec(x.to(cuda_device), "db5", mode=mode, level=level)
    rec = tptwt.waverec(got, "db5", mode=mode if mode == "periodization" else None)
    torch.cuda.synchronize()
    assert {k for k, v in _kernels.LAUNCHES.items() if v} == used
    assert _rel_err([g.cpu() for g in got], want) <= 1e-10
    assert float((rec.cpu()[..., :n] - x).abs().max()) <= 1e-10


@pytest.mark.cuda
def test_cuda_1d_kernels_refuse_grad(cuda_device):
    """Only filter gradients are refused on the 1d kernel routes (by
    design); data gradients run on the VJP launches, and a second backward
    through them (K8a's VJP on K8a, K8b's on K8b, K7 and K6 alike) matches
    the CPU's (float64)."""
    dl, dh, _, _ = _banks("db2")
    x = torch.randn(1, 70001, dtype=torch.float64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t8.flat_wavedec_lane_multi(x, torch.tensor(dl, requires_grad=True), dh, "reflect", 4)
    for n, mode, level, used in ((70001, "reflect", 4, {"K8a", "K8b"}), (70001, "reflect", 1, {"K7a", "K7b"}),
                                 (4096, "periodization", 3, {"K6a", "K6b"})):

        def run(t):
            coeffs = tptwt.wavedec(t[:, :n], "db2", mode=mode, level=level)
            rec = tptwt.waverec(coeffs, "db2", mode=mode if mode == "periodization" else None)
            return torch.cat([coeffs[0], rec], -1)

        _kernels.reset_launch_counts()
        got = _second_order(run, x)
        torch.cuda.synchronize()
        assert {k for k, v in _kernels.LAUNCHES.items() if v} == used
        _close_f64(got, _second_order(run, x.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kt_vjp_matches_plain(cuda_device, dtype):
    """KT's VJP (one K3 launch for the bands, one K4 launch for the input)
    against autograd through KT's plain version, K3's taps in every mode,
    along both axes."""
    tol = 2e-5 if dtype == torch.float32 else 1e-10
    gen = torch.Generator().manual_seed(19)
    for mode in AXIS_MODES:
        for axis in (-1, -2):
            x = torch.randn(2, 37, 40, dtype=dtype, generator=gen).to(cuda_device)
            dl, dh = (torch.randn(6, dtype=dtype, generator=gen).to(cuda_device) for _ in range(2))
            c = torch.randn(2, 6, dtype=torch.float64, generator=gen).to(cuda_device)
            bands = t2.dwt_axis_plain(x, axis, dl, dh, mode)

            # the plain taps' gradient, differentiable in the input and the bands
            def plain_taps(t, b0, b1):
                lo, hi = (f.detach().requires_grad_() for f in (dl, dh))
                with torch.enable_grad():
                    a0, a1 = t2.dwt_axis_plain(t, axis, lo, hi, mode)
                    return torch.autograd.grad((a0 * b0).sum() + (a1 * b1).sum(), (lo, hi), create_graph=True)

            ax = axis % x.ndim
            m, period, pad, code = t2._analysis_plan(x.shape[ax], 6, mode)
            leaves = [x.detach().requires_grad_(), *(b.detach().contiguous().requires_grad_() for b in bands)]
            _kernels.reset_launch_counts()
            out = t2.tap_grad(leaves[0], [leaves[1]], [leaves[2]], ax, 6, period, pad, code)
            got = torch.autograd.grad(out, leaves, c)
            torch.cuda.synchronize()
            assert _kernels.LAUNCHES["K3"] == 1 and _kernels.LAUNCHES["K4"] == 1
            plain_leaves = [t.detach().requires_grad_() for t in leaves]
            want = torch.autograd.grad(plain_taps(*plain_leaves), plain_leaves, (c[0].to(dtype), c[1].to(dtype)))
            for g, w in zip(got, want):
                assert float((g - w).abs().max()) <= tol * max(1.0, float(w.abs().max())), (mode, axis)


def _vjp_err(got, want) -> float:
    return max(_rel_err(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wavelet", ["db5", "haar", "coif17"])
@pytest.mark.parametrize("mode", [*PADDED, "valid"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_cuda_k7_k8_vjps_match_plain(cuda_device, dtype, wavelet, mode, depth):
    """K7a/K8a's VJP (one synthesis pyramid launch with the fold, counted
    as K7b/K8b) and K7b/K8b's (one analysis pyramid launch, counted as
    K7a/K8a) against autograd through the plain versions."""
    if mode == "valid" and depth > 1:
        pytest.skip("valid runs one level (K7a) only")
    dl, dh, rl, rh = _banks(wavelet)
    x = torch.randn(3, 70001, dtype=dtype, device=cuda_device, requires_grad=True)
    lo, his = t8.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
    cts = [_randn_like(t, i) for i, t in enumerate((lo, *his))]
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad((lo, *his), x, cts)
    torch.cuda.synchronize()
    fwd, syn = ("K7a", "K7b") if depth == 1 else ("K8a", "K8b")
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {syn: 1}
    z = x.detach().requires_grad_()
    ref_lo, ref_his = t8.multi_analysis_plain(z, dl, dh, mode, depth)
    (want,) = torch.autograd.grad((ref_lo, *ref_his), z, cts)
    assert _rel_err(got, want) <= _tol1d(dtype)
    if mode == "valid":
        return
    coeffs = [t.detach().requires_grad_() for t in (ref_lo, *ref_his[::-1])]
    pads = [_std_pad(len(dl))] * depth
    lens = [x.shape[-1]] + [h.shape[-1] for h in ref_his[:-1]]
    rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
    ct = _randn_like(rec, 9)
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, coeffs, ct)
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {fwd: 1}
    leaves = [c.detach().requires_grad_() for c in coeffs]
    want = torch.autograd.grad(t8.multi_synthesis_plain(leaves, rl, rh, pads, lens), leaves, ct)
    assert _vjp_err(got, want) <= _tol1d(dtype)


def _shortest(filt_len: int, depth: int, mode: str) -> int:
    """The shortest signal the forward K8a plan takes."""
    n = 2
    while True:
        try:
            t8._multi_plan(n, filt_len, depth, mode, 8)
            return n
        except ValueError:
            n += 1


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet", ["haar", "coif17"])
@pytest.mark.parametrize("mode", PADDED)
@pytest.mark.parametrize("depth", [1, 4])
def test_cuda_k7_k8_vjps_short_bands_and_adjoint(cuda_device, wavelet, mode, depth):
    """The VJP instances on the shortest and an odd signal the forward
    plan takes (a fold that wraps several times), float64: against
    autograd through the plain versions within 1e-10, and the adjoint
    identity <K x, y> = <x, K^T y> within 1e-12 of |K x| |y|."""
    dl, dh, rl, rh = _banks(wavelet)
    n0 = _shortest(len(dl), depth, mode)
    for n in (n0, n0 + 3, 70001):
        x = torch.randn(2, n, dtype=torch.float64, device=cuda_device, requires_grad=True)
        outs = t8.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
        outs = [outs[0], *outs[1]]
        flat = [o.detach() for o in outs]
        cts = [_randn_like(t, i) for i, t in enumerate(outs)]
        (got,) = torch.autograd.grad(outs, x, cts)
        z = x.detach().requires_grad_()
        ref_lo, ref_his = t8.multi_analysis_plain(z, dl, dh, mode, depth)
        (want,) = torch.autograd.grad((ref_lo, *ref_his), z, cts)
        assert _rel_err(got, want) <= 1e-10
        lhs = sum(float((o * c).sum()) for o, c in zip(flat, cts))
        scale = math.sqrt(sum(float((o * o).sum()) for o in flat)) * math.sqrt(sum(float((c * c).sum()) for c in cts))
        assert abs(lhs - float((x.detach() * got).sum())) <= 1e-12 * scale
        coeffs = [t.detach().requires_grad_() for t in (ref_lo, *ref_his[::-1])]
        pads = [_std_pad(len(dl))] * depth
        lens = [n] + [h.shape[-1] for h in ref_his[:-1]]
        rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
        ct = _randn_like(rec, 9)
        got = torch.autograd.grad(rec, coeffs, ct)
        leaves = [c.detach().requires_grad_() for c in coeffs]
        want = torch.autograd.grad(t8.multi_synthesis_plain(leaves, rl, rh, pads, lens), leaves, ct)
        assert _vjp_err(got, want) <= 1e-10
        scale = float(rec.detach().norm()) * float(ct.norm())
        rhs = sum(float((c.detach() * g).sum()) for c, g in zip(coeffs, got))
        assert abs(float((rec.detach() * ct).sum()) - rhs) <= 1e-12 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wavelet", ["db5", "haar", "coif17"])
@pytest.mark.parametrize("n,level", [(2**14, 10), (3 * 2**10, 5), (64, 6)])
def test_cuda_k6_vjps_match_plain(cuda_device, dtype, wavelet, n, level):
    """K6a's VJP (K6b) and K6b's (K6a), one launch per run."""
    dl, dh, rl, rh = _banks(wavelet)
    x = torch.randn(3, n, dtype=dtype, device=cuda_device, requires_grad=True)
    bands = t6.fused_wavedec1d_per(x, dl, dh, level)
    cts = [_randn_like(b, i) for i, b in enumerate(bands)]
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(bands, x, cts)
    torch.cuda.synchronize()
    runs = -(-level // 4)
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K6b": runs}
    z = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(t6.wavedec1d_per_plain(z, dl, dh, level), z, cts)
    assert _rel_err(got, want) <= _tol1d(dtype)
    leaves = [b.detach().requires_grad_() for b in bands]
    rec = t6.fused_waverec1d_per(leaves, rl, rh)
    ct = _randn_like(rec, 9)
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, leaves, ct)
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K6a": runs}
    plain = [b.detach().requires_grad_() for b in bands]
    want = torch.autograd.grad(t6.waverec1d_per_plain(plain, rl, rh), plain, ct)
    assert _vjp_err(got, want) <= _tol1d(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,level", [("periodic", 10), ("reflect", 10), ("reflect", 1), ("periodization", 10)])
def test_cuda_1d_public_gradients_match_cpu(cuda_device, mode, level):
    n = 2**17 if mode == "periodization" else 70001
    x = torch.randn(2, n, dtype=torch.float64)
    weight = torch.randn(2, n, dtype=torch.float64)

    def grad_on(device):
        xd = x.to(device).requires_grad_()
        coeffs = tptwt.wavedec(xd, "db5", mode=mode, level=level)
        rec = tptwt.waverec(coeffs, "db5", mode=mode if mode == "periodization" else None)[..., :n]
        loss = (rec * weight.to(device)).sum() + sum((c**2).sum() for c in coeffs)
        return torch.autograd.grad(loss, xd)[0]

    got = grad_on(cuda_device)
    assert float((got.cpu() - grad_on("cpu")).abs().max()) <= 1e-10


# ---------------------------------------------------------------------------
# the 2d periodization pyramid: K5a/K5b and their VJPs
# ---------------------------------------------------------------------------

K5_SHAPES = [
    (16, 1024, 1024, 4),  # the headline: three depth-1 runs of tiles, then a whole image
    (3, 128, 128, 3),  # the whole image, one launch
    (2, 512, 256, 4),  # tiled runs
    (2, 96, 160, 5),  # not a power of two, ragged tiles
    (1, 24, 20, 2),  # coif17's 102 taps wrap these bands several times
]


@pytest.mark.cuda
# db20's 40 taps find no tile within the plan's 64 KB target on the tiled
# shape and take the limit's depth-1 runs
@pytest.mark.parametrize(
    "dtype,wavelet", [*CASES, (torch.float32, "haar"), (torch.float32, "sym8"), (torch.float32, "db20")]
)
@pytest.mark.parametrize("b,h,w,level", K5_SHAPES)
def test_cuda_k5_matches_plain(cuda_device, dtype, wavelet, b, h, w, level):
    dl, dh, rl, rh = _banks(wavelet)
    if not t5.fused_wavedec2d_applicable(h, w, len(dl), level, dtype):
        pytest.skip("the K5 plan declines this shape (the per-level route runs it)")
    x = torch.randn(b, h, w, dtype=dtype, device=cuda_device)
    runs = len(t5._plan_runs(h, w, len(dl), level, dtype))
    _kernels.reset_launch_counts()
    got = t5.fused_wavedec2d_per(x, dl, dh, level)
    want = t5.wavedec2d_per_plain(x, dl, dh, level)
    assert _rel_err(_flat2(got), _flat2(want)) <= _tol1d(dtype)
    rec = t5.fused_waverec2d_per(want, rl, rh)
    assert _rel_err(rec, t5.waverec2d_per_plain(want, rl, rh)) <= _tol1d(dtype)
    assert _rel_err(rec, x) <= 10 * _tol1d(dtype)
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K5a": runs, "K5b": runs}


def _flat2(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wavelet", [*CASES, (torch.float32, "haar")])
@pytest.mark.parametrize("b,h,w,level", K5_SHAPES)
def test_cuda_k5_vjps_match_plain(cuda_device, dtype, wavelet, b, h, w, level):
    """K5a's VJP (K5b) and K5b's (K5a) against autograd through the plain
    versions; float64 also holds the adjoint identity."""
    dl, dh, rl, rh = _banks(wavelet)
    if not t5.fused_wavedec2d_applicable(h, w, len(dl), level, dtype):
        pytest.skip("the K5 plan declines this shape (the per-level route runs it)")
    x = torch.randn(b, h, w, dtype=dtype, device=cuda_device, requires_grad=True)
    runs = len(t5._plan_runs(h, w, len(dl), level, dtype))
    bands = _flat2(t5.fused_wavedec2d_per(x, dl, dh, level))
    cts = [_randn_like(t, i) for i, t in enumerate(bands)]
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(bands, x, cts)
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K5b": runs}
    z = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(_flat2(t5.wavedec2d_per_plain(z, dl, dh, level)), z, cts)
    assert _rel_err(got, want) <= _tol1d(dtype)
    if dtype == torch.float64:
        lhs = sum(float((o.detach() * c).sum()) for o, c in zip(bands, cts))
        assert abs(lhs - float((x.detach() * got).sum())) <= 1e-12 * max(1.0, abs(lhs))
    leaves = [t.detach().requires_grad_() for t in bands]
    coeffs = [leaves[0]] + [tuple(leaves[1 + 3 * i : 4 + 3 * i]) for i in range(level)]
    rec = t5.fused_waverec2d_per(coeffs, rl, rh)
    ct = _randn_like(rec, 99)
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, leaves, ct)
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K5a": runs}
    plain = [t.detach().requires_grad_() for t in bands]
    pcoeffs = [plain[0]] + [tuple(plain[1 + 3 * i : 4 + 3 * i]) for i in range(level)]
    want = torch.autograd.grad(t5.waverec2d_per_plain(pcoeffs, rl, rh), plain, ct)
    assert _vjp_err(got, want) <= _tol1d(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,level", [((16, 1024, 1024), 4), ((2, 128, 128), 3), ((2, 256, 512), 4), ((2, 64, 64), 6)]
)
def test_cuda_k5_public_path_matches_cpu(cuda_device, shape, level):
    x = torch.randn(*shape, dtype=torch.float64)
    weight = torch.randn(*shape, dtype=torch.float64)

    def run(device):
        xd = x.to(device).requires_grad_()
        coeffs = tptwt.wavedec2(xd, "db4", mode="periodization", level=level)
        rec = tptwt.waverec2(coeffs, "db4")
        loss = (rec * weight.to(device)).sum() + sum((b**2).sum() for t in coeffs[1:] for b in t)
        return _flat2(coeffs), rec, torch.autograd.grad(loss, xd)[0]

    _kernels.reset_launch_counts()
    coeffs, rec, grad = run(cuda_device)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K5a"] and _kernels.LAUNCHES["K5b"]
    assert not (_kernels.LAUNCHES["K1"] or _kernels.LAUNCHES["K2"])
    want = run("cpu")
    assert _rel_err([c.cpu() for c in coeffs], want[0]) <= 1e-10
    assert float((rec.cpu() - x).abs().max()) <= 1e-10
    assert float((grad.cpu() - want[2]).abs().max()) <= 1e-10


# an odd-length bank (a user's 7 taps) on the inputs of the K5, K6 and
# K7/K8 routes, whose gates decline it: K3/K4 run every level
ODD_BANK_CASES = [
    ((1, 64), "periodization", 2),
    ((3, 64), "periodization", 1),
    ((2, 70000), "reflect", 2),
    ((2, 70000), "periodic", 1),
    ((2, 70000), "zero", 3),
    ((1, 64, 64), "periodization", 2),
    ((2, 64, 48), "periodization", 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode,level", ODD_BANK_CASES)
def test_cuda_odd_bank_matches_cpu(cuda_device, shape, mode, level):
    gen = torch.Generator().manual_seed(73)
    bank = tuple(torch.randn(7, generator=gen, dtype=torch.float64).numpy() for _ in range(4))
    x = torch.randn(*shape, generator=gen, dtype=torch.float64)
    one_d = len(shape) == 2
    fwd, inv = (tptwt.wavedec, tptwt.waverec) if one_d else (tptwt.wavedec2, tptwt.waverec2)
    flat = (lambda c: list(c)) if one_d else _flat2
    rec_mode = "periodization" if mode == "periodization" else None
    _kernels.reset_launch_counts()
    got = fwd(x.to(cuda_device), bank, mode=mode, level=level)
    torch.cuda.synchronize()
    assert {k for k, v in _kernels.LAUNCHES.items() if v} == {"K3"}
    want = fwd(x, bank, mode=mode, level=level)
    assert [tuple(c.shape) for c in flat(got)] == [tuple(c.shape) for c in flat(want)]
    assert _rel_err([c.cpu() for c in flat(got)], flat(want)) <= 1e-10
    try:
        rec_want = inv(want, bank, mode=rec_mode)
    except AssertionError:
        # a multi-level chain of odd-bank bands is refused on both devices
        with pytest.raises(AssertionError, match="padding error"):
            inv(got, bank, mode=rec_mode)
        return
    rec = inv(got, bank, mode=rec_mode)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K4"] and not any(
        _kernels.LAUNCHES[k] for k in ("K5b", "K6b", "K7b", "K8b", "K2")
    )
    assert tuple(rec.shape) == tuple(rec_want.shape)
    assert float((rec.cpu() - rec_want).abs().max()) <= 1e-10


@pytest.mark.cuda
def test_cuda_2d_long_last_axis_runs_k7(cuda_device):
    """A 2d level whose last axis passes the gate runs K7 along it."""
    x = torch.randn(1, 6, 70001, dtype=torch.float64)
    want = tptwt.wavedec2(x, "db2", mode="reflect", level=1)
    _kernels.reset_launch_counts()
    got = tptwt.wavedec2(x.to(cuda_device), "db2", mode="reflect", level=1)
    rec = tptwt.waverec2(got, "db2")
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K7a"] == 1 and _kernels.LAUNCHES["K7b"] == 2
    assert _rel_err([got[0].cpu(), *(b.cpu() for b in got[1])], [want[0], *want[1]]) <= 1e-10
    assert float((rec.cpu()[..., :70001] - x).abs().max()) <= 1e-10


# ---------------------------------------------------------------------------
# K9a/K9b: the tensor-core level (opt-in PTWT_TPU_MXU2D=1)
# ---------------------------------------------------------------------------


@pytest.fixture
def mxu2d(cuda_device, monkeypatch):
    """The opt-in set and exact float32 products in the plain versions."""
    monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return cuda_device


def _k9_plain(monkeypatch, fn, *args):
    """``fn`` on the plain route: K9's plain versions on the card."""
    with monkeypatch.context() as m:
        m.setattr(t2d, "_on_cpu", lambda t: True)
        return fn(*args)


K9_CASES = [
    *[(w, s) for w in ("haar", "db4", "db8", "sym6", "db20") for s in ((2, 128, 256), (1, 256, 512))],
    ("db4", (16, 1024, 1024)),  # the headline's level 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet,shape", K9_CASES)
@pytest.mark.parametrize("mode", ["periodic", "periodization"])
def test_cuda_k9_matches_plain(mxu2d, monkeypatch, wavelet, shape, mode):
    dl, dh, rl, rh = _banks(wavelet)
    x = torch.randn(*shape, dtype=torch.float32, device=mxu2d)
    _kernels.reset_launch_counts()
    got = t2d.fused2_dwt_level(x, dl, dh, mode)
    want = _k9_plain(monkeypatch, t2d.fused2_dwt_level, x, dl, dh, mode)
    assert _rel_err(list(got), list(want)) <= 2e-5
    rec = t2d.fused2_idwt_level(want, rl, rh, mode)
    ref = _k9_plain(monkeypatch, t2d.fused2_idwt_level, want, rl, rh, mode)
    assert _rel_err(rec, ref) <= 2e-5
    assert float((rec - x).abs().max()) <= 1e-4
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K9a": 1, "K9b": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("wavelet,shape", K9_CASES)
@pytest.mark.parametrize("mode", ["periodic", "periodization"])
def test_cuda_k9_vjps_match_plain(mxu2d, monkeypatch, wavelet, shape, mode):
    """K9a's VJP (a K9b launch, folding the periodic wrap rows) and K9b's
    (a K9a launch, zero-bounded for periodic) against autograd through
    the plain versions."""
    dl, dh, rl, rh = _banks(wavelet)
    x = torch.randn(*shape, dtype=torch.float32, device=mxu2d, requires_grad=True)
    bands = t2d.fused2_dwt_level(x, dl, dh, mode)
    cts = [_randn_like(b, i) for i, b in enumerate(bands)]
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(bands, x, cts)
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K9b": 1}
    plain = _k9_plain(monkeypatch, t2d.fused2_dwt_level, x, dl, dh, mode)
    (want,) = torch.autograd.grad(plain, x, cts)
    assert _rel_err(grad, want) <= 2e-5
    subbands = [b.detach().requires_grad_() for b in bands]
    rec = t2d.fused2_idwt_level(subbands, rl, rh, mode)
    ct = _randn_like(rec, 9)
    _kernels.reset_launch_counts()
    grads = torch.autograd.grad(rec, subbands, ct)
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K9a": 1}
    plain = _k9_plain(monkeypatch, t2d.fused2_idwt_level, subbands, rl, rh, mode)
    want = torch.autograd.grad(plain, subbands, ct)
    assert _rel_err(list(grads), list(want)) <= 2e-5


# each K9 instance through its wrapper: the smallest image the gate takes,
# a ragged one (periodic m = 195 x 387: a 3-row last tile row) and a
# user's odd 7-tap bank
K9_LAUNCH_CASES = [
    ((64, 256, 256), "db4", "periodic"),
    ((64, 256, 256), "db4", "periodization"),
    ((4, 384, 768), "db4", "periodic"),
    ((4, 384, 768), "sym6", "periodization"),
    ((4, 384, 768), "odd7", "periodic"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bank,mode", K9_LAUNCH_CASES)
def test_cuda_k9_instances_match_plain(mxu2d, shape, bank, mode):
    """K9a, K9b, K9a's VJP (K9b folding the band rows past half the
    period) and K9b's VJP (K9a, zero-bounded in periodic) against their
    plain versions (2e-5 relative to the band's magnitude), one launch
    each."""
    if bank == "odd7":
        gen = torch.Generator().manual_seed(74)
        lo, hi, rl, rh = ((torch.randn(7, generator=gen, dtype=torch.float64) / 7**0.5).tolist() for _ in range(4))
    else:
        lo, hi, rl, rh = (torch.as_tensor(f).tolist() for f in _banks(bank))
    b, h, w = shape
    L = len(lo)
    p = L // 2 - 1 if mode == "periodization" else _std_pad(L)
    m_h, m_w = (h // 2, w // 2) if mode == "periodization" else ((h + 2 * p - L) // 2 + 1, (w + 2 * p - L) // 2 + 1)
    circ = mode == "periodization"
    fold = (h // 2, w // 2, h, w)
    x = torch.randn(shape, device=mxu2d)
    bands = [torch.randn(b, m_h, m_w, device=mxu2d) for _ in range(4)]
    for kernel, fn, args in (
        ("K9a", "dwt", (x, lo, hi, h, w, m_h, m_w, p)),
        ("K9b", "idwt", (bands, rl, rh, h, w, p, circ)),
        ("K9b", "idwt", (bands, lo, hi, h, w, p, True, fold)),
        ("K9a", "dwt", (x, rl, rh, h, w, m_h, m_w, p, circ)),
    ):
        _kernels.reset_launch_counts()
        got = getattr(t9, f"mxu2_{fn}_call")(*args)
        torch.cuda.synchronize()
        assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {kernel: 1}
        assert _rel_err(got, getattr(t9, f"mxu2_{fn}_plain")(*args)) <= 2e-5


@pytest.mark.cuda
def test_cuda_k9_routes(mxu2d, monkeypatch):
    """The headline round trip takes K9 on level 1 only; float64, and the
    opt-in unset, keep K1/K2."""
    x = torch.randn(2, 1024, 1024, dtype=torch.float32, device=mxu2d)
    _kernels.reset_launch_counts()
    rec = tptwt.waverec2(tptwt.wavedec2(x, "db4", mode="periodic", level=4), "db4", mode="periodic")
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {
        "K9a": 1, "K9b": 1, "K1": 1, "K2": 1, "K3": 4, "K4": 4}
    assert float((rec - x).abs().max()) <= 1e-4
    _kernels.reset_launch_counts()
    t2d.fused2_dwt_level(x.double(), *_banks("db4")[:2], "periodic")
    monkeypatch.delenv("PTWT_TPU_MXU2D")
    t2d.fused2_dwt_level(x, *_banks("db4")[:2], "periodic")
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K1": 2}
    with pytest.raises(NotImplementedError, match="filter gradient"):
        monkeypatch.setenv("PTWT_TPU_MXU2D", "1")
        dl, dh, _, _ = _banks("db4")
        t2d.fused2_dwt_level(x, torch.tensor(dl, requires_grad=True), dh, "periodic")


# ---------------------------------------------------------------------------
# K1/K2 as shared-memory tiles (csrc/dwt2.cu): tile edges, long filters,
# batches of small crops
# ---------------------------------------------------------------------------


def _tile_cases():
    # below one tile, the headline's level 4 (134 <-> 4 x 70), ragged tiles
    # with h != w, an odd periodization image, and a batch of small crops
    # past the 65,535 blocks of a grid's y and z
    shapes = [(3, 12, 16), (16, 134, 134), (2, 76, 142), (3, 45, 71)]
    banks = [*CASES, (torch.float32, "haar"), (torch.float32, "coif17")]
    cases = [(d, w, s, m) for d, w in banks for s in shapes for m in ("periodic", "periodization")
             if m == "periodization" or not (s[1] % 2 or s[2] % 2)]
    cases += [(torch.float32, "db4", (70000, 16, 16), m) for m in ("periodic", "periodization")]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wavelet,shape,mode", _tile_cases())
def test_cuda_k1_k2_tiles_match_plain(cuda_device, dtype, wavelet, shape, mode):
    """K1, K2, K1's VJP (K2 with the fold or the clamp) and K2's VJP (K1,
    zero-bounded for periodic) against their plain versions."""
    dl, dh, rl, rh = _banks(wavelet)
    tol = 2e-5 if dtype == torch.float32 else 1e-10
    x = torch.randn(*shape, dtype=dtype, device=cuda_device, requires_grad=True)
    _kernels.reset_launch_counts()
    bands = t2d.fused2_dwt_level(x, dl, dh, mode)
    assert _rel_err(list(bands), list(t2d.dwt2_level_plain(x, dl, dh, mode))) <= tol
    cts = [_randn_like(b, i) for i, b in enumerate(bands)]
    (grad,) = torch.autograd.grad(bands, x, cts)
    assert _rel_err(grad, t2d.dwt2_level_vjp_plain(x, dl, dh, mode, cts)) <= tol
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K1"] == 1 and _kernels.LAUNCHES["K2"] == 1
    if shape[-1] % 2 or shape[-2] % 2:
        return  # K2 reconstructs even shapes only
    p = 0 if mode == "periodization" else _std_pad(len(dl))
    subbands = [b.detach().requires_grad_() for b in bands]
    rec = t2d.fused2_idwt_level(subbands, rl, rh, mode)
    assert _rel_err(rec, t2d.idwt2_level_plain(subbands, rl, rh, mode, [(p, p)] * 2)) <= tol
    ct = _randn_like(rec, 9)
    grads = torch.autograd.grad(rec, subbands, ct)
    want = t2d.idwt2_level_vjp_plain(subbands, rl, rh, mode, [(p, p)] * 2, ct)
    assert _rel_err(list(grads), list(want)) <= tol
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K1"] == 2 and _kernels.LAUNCHES["K2"] == 2


# ---------------------------------------------------------------------------
# launches of 2^31 outputs and more (K1, K2, K1's VJP, the two-pair K4)
# ---------------------------------------------------------------------------

BIG = (32, 8192, 8192)  # float32: 8.6 GB


@pytest.fixture
def plain(monkeypatch):
    """Run ``fn(*args, **kwargs)`` on the plain versions, on the card."""

    def run(fn, *args, **kwargs):
        with monkeypatch.context() as m:
            for module in (t2, t2d, t5, t7, t8):
                m.setattr(module, "_on_cpu", lambda t: True)
            return fn(*args, **kwargs)

    return run


def _ends(t, axis=0):
    """The first and the last image of a batch, as batches of one."""
    n = t.shape[axis]
    return t.narrow(axis, 0, 1), t.narrow(axis, n - 1, 1)


def _flat_coeffs(coeffs):
    return [coeffs[0], *coeffs[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodic", "reflect"])
def test_cuda_wavedec2_waverec2_past_2_31_outputs(cuda_device, plain, mode):
    """One level of ``[32, 8192, 8192]`` float32 and back.  Periodic: K1
    writes 4 * 32 * 4098^2 = 2,149,581,312 outputs, K2 32 * 8192^2 = 2^31.
    Reflect: K3 along H and the two-pair K4 along W write 2 * 32 * 4099 *
    8192 = 2,149,056,512.  The first and the last image against the plain
    version run on that image alone.  Peak device memory is about 26 GB
    in periodic (the image, its bands, the reconstruction) and more in
    reflect (padded copies besides); chip_smoke.py's phase 13, which runs
    both modes and K1's VJP at this size, peaked at 43 GB on an H100."""
    torch.manual_seed(0)
    x = torch.randn(BIG, dtype=torch.float32, device=cuda_device)
    _kernels.reset_launch_counts()
    coeffs = tptwt.wavedec2(x, "db4", mode=mode, level=1)
    rec = tptwt.waverec2(coeffs, "db4", mode=mode)
    torch.cuda.synchronize()
    used = ("K1", "K2") if mode == "periodic" else ("K3", "K4")
    assert all(_kernels.LAUNCHES[k] >= 1 for k in used)
    ends_x = _ends(x)
    del x
    flat = _flat_coeffs(coeffs)
    for i, xi in enumerate(ends_x):
        want = plain(tptwt.wavedec2, xi, "db4", mode=mode, level=1)
        got = [_ends(c)[i] for c in flat]
        assert _rel_err(got, _flat_coeffs(want)) <= 2e-5
        back = plain(tptwt.waverec2, (got[0], tuple(got[1:])), "db4", mode=mode)
        assert _rel_err(_ends(rec)[i], back) <= 2e-5
        assert float((_ends(rec)[i] - xi).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_k1_vjp_past_2_31_outputs(cuda_device):
    """K1's VJP (a K2 launch with the fold) on the periodic level of
    ``[32, 8192, 8192]`` float32, whose cotangents hold 2,149,581,312
    values.  The first and the last image against the plain VJP on that
    image alone.  Peak device memory is about 35 GB (the image, its bands,
    their cotangents, the gradient, 8.6 GB each)."""
    dl, dh, _, _ = _banks("db4")
    torch.manual_seed(1)
    x = torch.randn(BIG, dtype=torch.float32, device=cuda_device, requires_grad=True)
    bands = t2d.fused2_dwt_level(x, dl, dh, "periodic")
    cts = torch.randn((4, *bands[0].shape), dtype=torch.float32, device=cuda_device)
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(bands, x, tuple(cts.unbind(0)))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K2"] == 1
    del bands
    for i, (xi, gi) in enumerate(zip(_ends(x.detach()), _ends(grad))):
        ci = [_ends(c)[i] for c in cts.unbind(0)]
        assert _rel_err(gi, t2d.dwt2_level_vjp_plain(xi, dl, dh, "periodic", ci)) <= 2e-5


# ---------------------------------------------------------------------------
# empty batches, and the 3d and fully separable transforms on K3/K4
# ---------------------------------------------------------------------------

ALL_MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
EMPTY_CASES = [
    *(("1d", (0, 64), mode, 2) for mode in ALL_MODES),
    ("1d", (0, 70000), "reflect", 6),  # the fused K8 run, then K3/K4 levels
    *(("2d", (0, 32, 32), mode, 2) for mode in ALL_MODES),
    *(("3d", (0, 8, 8, 8), mode, 2) for mode in ALL_MODES),
    *(("fs2", (0, 16, 16), mode, 1) for mode in ALL_MODES),
]
ND_FUNCS = {
    "1d": (tptwt.wavedec, tptwt.waverec),
    "2d": (tptwt.wavedec2, tptwt.waverec2),
    "3d": (tptwt.wavedec3, tptwt.waverec3),
    "fs2": (tptwt.fswavedec2, tptwt.fswaverec2),
    "fs3": (tptwt.fswavedec3, tptwt.fswaverec3),
}


def _leaves(coeffs) -> list:
    out = []
    for c in coeffs:
        if isinstance(c, dict):
            out.extend(c[k] for k in sorted(c))
        elif isinstance(c, tuple):
            out.extend(c)
        else:
            out.append(c)
    return out


def _inverse(kind, coeffs, wavelet, mode, **kwargs):
    inv = ND_FUNCS[kind][1]
    if kind.startswith("fs"):  # no mode argument: the padded synthesis
        return inv(coeffs, wavelet, **kwargs)
    return inv(coeffs, wavelet, mode=mode if mode == "periodization" else None, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,mode,level", EMPTY_CASES)
def test_cuda_empty_batch_matches_cpu(cuda_device, kind, shape, mode, level):
    """An empty batch gives the CPU path's empty bands and reconstruction
    (the input's shape) on the card, and launches no kernel."""
    fwd = ND_FUNCS[kind][0]
    x = torch.zeros(shape, dtype=torch.float32)
    want = fwd(x, "db4", mode=mode, level=level)
    _kernels.reset_launch_counts()
    got = fwd(x.to(cuda_device), "db4", mode=mode, level=level)
    rec = _inverse(kind, got, "db4", mode)
    torch.cuda.synchronize()
    assert [tuple(c.shape) for c in _leaves(got)] == [tuple(c.shape) for c in _leaves(want)]
    assert tuple(rec.shape) == tuple(_inverse(kind, want, "db4", mode).shape)
    assert rec.device.type == "cuda" and not any(_kernels.LAUNCHES.values())


# (kind, shape, wavelet, mode, level, axes): odd and even axes, every mode,
# float64 against the CPU path; K3 launches per level, K4 launches per level
ND_CASES = [
    *(("3d", (2, 17, 20, 23), "db3", mode, 2, None) for mode in ALL_MODES),
    ("3d", (9, 2, 12, 14), "sym4", "zero", 1, (0, 2, 3)),
    ("3d", (1, 5, 6, 7), "coif17", "periodization", 1, None),
    *(("fs2", (3, 33, 40), "db3", mode, 2, None) for mode in ALL_MODES),
    ("fs2", (14, 3, 20), "bior2.2", "symmetric", 2, (0, 2)),
    *(("fs3", (2, 17, 20, 23), "db2", mode, 2, None) for mode in ("reflect", "periodic", "periodization")),
]
ND_LAUNCHES = {"3d": (3, 4), "fs2": (2, 2), "fs3": (3, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,wavelet,mode,level,axes", ND_CASES)
def test_cuda_nd_transforms_match_cpu(cuda_device, kind, shape, wavelet, mode, level, axes):
    """``wavedec3``/``waverec3`` and ``fswavedec2/3``/``fswaverec2/3`` on the
    card against the CPU path (float64): coefficients, reconstruction, the
    launches of each direction and of the backward (each K3 launch's VJP
    is one K4 launch and each K4 launch's one K3 launch), and the
    gradient."""
    fwd = ND_FUNCS[kind][0]
    kwargs = {} if axes is None else {"axes": axes}
    gen = torch.Generator().manual_seed(80)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)

    def run(device):
        xd = x.to(device).requires_grad_()
        coeffs = fwd(xd, wavelet, mode=mode, level=level, **kwargs)
        counts = dict(_kernels.LAUNCHES)
        try:
            rec = _inverse(kind, coeffs, wavelet, mode, **kwargs)
        except ValueError:  # fswaverec* of a periodization chain (as ptwt_tpu)
            assert kind.startswith("fs") and mode == "periodization" and level > 1
            rec = None
        counts["inverse K4"] = _kernels.LAUNCHES["K4"]
        leaves = _leaves(coeffs)
        weights = [torch.randn(t.shape, generator=torch.Generator().manual_seed(81 + i), dtype=torch.float64)
                   for i, t in enumerate(leaves)]
        loss = sum((t * w.to(device)).sum() for t, w in zip(leaves, weights))
        if rec is not None:
            loss = loss + (rec**2).sum()
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(loss, xd)
        return leaves, rec, grad, counts

    _kernels.reset_launch_counts()
    leaves, rec, grad, fwd_counts = run(cuda_device)
    back = dict(_kernels.LAUNCHES)
    torch.cuda.synchronize()
    k3, k4 = ND_LAUNCHES[kind]
    inverse_k4 = fwd_counts.pop("inverse K4")
    assert {k: v for k, v in fwd_counts.items() if v} == {"K3": k3 * level}
    want_leaves, want_rec, want_grad, _ = run("cpu")
    assert [tuple(c.shape) for c in leaves] == [tuple(c.shape) for c in want_leaves]
    assert _rel_err([c.detach().cpu() for c in leaves], [c.detach() for c in want_leaves]) <= 1e-10
    if want_rec is None:
        assert rec is None
        assert {k: v for k, v in back.items() if v} == {"K4": k3 * level}
    else:
        assert _rel_err(rec.detach().cpu(), want_rec.detach()) <= 1e-10
        assert inverse_k4 == k4 * level
        assert {k: v for k, v in back.items() if v} == {"K3": k4 * level, "K4": k3 * level}
    assert _rel_err(grad.cpu(), want_grad) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["3d", "fs2"])
def test_cuda_nd_round_trip_float32(cuda_device, kind):
    """A float32 round trip of a few levels at a size that spans many tiles
    (the d3 and fs2 rows' shapes, cut in batch): the input within 1e-4,
    launches K3 x (axes x levels), K4 x (2 or 4 per level)."""
    shape, level = ((2, 100, 100, 100), 3) if kind == "3d" else ((2, 1000, 1000), 5)
    fwd = ND_FUNCS[kind][0]
    x = torch.randn(shape, dtype=torch.float32, device=cuda_device)
    _kernels.reset_launch_counts()
    coeffs = fwd(x, "db5", mode="reflect", level=level)
    rec = _inverse(kind, coeffs, "db5", "reflect")
    torch.cuda.synchronize()
    k3, k4 = ND_LAUNCHES[kind]
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K3": k3 * level, "K4": k4 * level}
    crop = rec[(Ellipsis, *(slice(0, n) for n in shape[1:]))]
    assert float((crop - x).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the stationary and boundary-wavelet matrix transforms
# ---------------------------------------------------------------------------


def _matrix_pair(dim):
    return {1: (tptwt.MatrixWavedec, tptwt.MatrixWaverec), 2: (tptwt.MatrixWavedec2, tptwt.MatrixWaverec2),
            3: (tptwt.MatrixWavedec3, tptwt.MatrixWaverec3)}[dim]


def _flat_matrix(coeffs):
    out = []
    for c in coeffs:
        out += [c[k] for k in sorted(c)] if isinstance(c, dict) else list(c) if isinstance(c, tuple) else [c]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_matrix_1d_matches_cpu(cuda_device, dtype):
    """``bench.py``'s mat1d row at batch 2 (db5, 10 levels, ``10**6``
    samples): the analysis launches K8a once (its sameshift instance,
    levels 1-4) and K3 five times, the synthesis K4 five times and K8b
    once; bands, reconstruction and the gradient against the CPU."""
    gen = torch.Generator().manual_seed(90)
    x = torch.randn(2, 10**6, generator=gen, dtype=torch.float64)
    tol = 1e-10 if dtype == torch.float64 else 2e-5

    def run(device):
        xd = x.to(device=device, dtype=dtype).requires_grad_()
        _kernels.reset_launch_counts()
        coeffs = tptwt.MatrixWavedec("db5", 10)(xd)
        fwd = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        _kernels.reset_launch_counts()
        rec = tptwt.MatrixWaverec("db5")(coeffs)
        inv = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        weights = [torch.randn(c.shape, generator=torch.Generator().manual_seed(91 + i), dtype=dtype)
                   for i, c in enumerate(coeffs)]
        loss = sum((c * w.to(device)).sum() for c, w in zip(coeffs, weights)) + (rec**2).sum()
        (grad,) = torch.autograd.grad(loss, xd)
        return coeffs, rec, grad, fwd, inv

    coeffs, rec, grad, fwd, inv = run(cuda_device)
    torch.cuda.synchronize()
    assert fwd == {"K8a": 1, "K3": 5} and inv == {"K4": 5, "K8b": 1}
    want, want_rec, want_grad, fwd_cpu, _ = run("cpu")
    assert fwd_cpu == {}
    assert _rel_err([c.detach().cpu() for c in coeffs], [c.detach() for c in want]) <= tol
    assert _rel_err(rec.detach().cpu(), want_rec.detach()) <= tol
    assert float((rec.detach().cpu() - x.to(dtype)).abs().max()) <= (1e-10 if dtype == torch.float64 else 1e-4)
    assert _rel_err(grad.cpu(), want_grad) <= 10 * tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dim,shape,kw,cutoff",
    [(2, (4, 256, 256), {"separable": True}, None), (2, (2, 64, 48), {"separable": False}, None),
     (2, (2, 40, 36), {"separable": False, "nonseparable": "reference"}, None),
     (2, (2, 3000, 40), {"separable": True}, 2048), (3, (2, 34, 40, 46), {}, None),
     (3, (1, 20, 16, 300), {}, 128), (1, (3, 4096), {"orthogonalization": "gramschmidt"}, None)],
)
def test_cuda_matrix_transforms_match_cpu(cuda_device, dim, shape, kw, cutoff):
    """Dense products, the long axes (one K3 launch each way along a long
    axis, ``axis=-2`` or ``-1``) and both 2d backends, float64, against the
    CPU."""
    from ptwt_tpu_torch.ops import long_boundary_cutoff, set_long_boundary_cutoff

    dec_cls, rec_cls = _matrix_pair(dim)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(92), dtype=torch.float64)
    rec_kw = {k: v for k, v in kw.items() if k != "odd_coeff_padding_mode"}
    old = long_boundary_cutoff()
    try:
        if cutoff is not None:
            set_long_boundary_cutoff(cutoff)
        out = {}
        for device in (cuda_device, "cpu"):
            coeffs = dec_cls("db3", 2, **kw)(x.to(device))
            out[str(device)] = (coeffs, rec_cls("db3", **rec_kw)(coeffs))
    finally:
        set_long_boundary_cutoff(old)
    (got, got_rec), (want, want_rec) = out[str(cuda_device)], out["cpu"]
    assert _rel_err([c.cpu() for c in _flat_matrix(got)], _flat_matrix(want)) <= 1e-10
    assert _rel_err(got_rec.cpu(), want_rec) <= 1e-10


@pytest.mark.cuda
def test_cuda_matrix_products_ignore_tf32(cuda_device):
    """With the global float32 matmul precision at ``"high"`` (TF32), a
    float32 ``MatrixWavedec``/``MatrixWavedec2`` on the card still agrees
    with its float64 result within 1e-5 relative: every product runs at
    the transforms' own precision, ``"highest"``; the caller's setting is
    back afterwards."""
    prev = torch.get_float32_matmul_precision()
    gen = torch.Generator().manual_seed(93)
    cases = [(tptwt.MatrixWavedec("db4", 4), torch.randn(8, 2048, generator=gen, dtype=torch.float64)),
             (tptwt.MatrixWavedec2("db4", 4), torch.randn(4, 256, 256, generator=gen, dtype=torch.float64))]
    try:
        torch.set_float32_matmul_precision("high")
        for dec, x in cases:
            want = [c.cpu() for c in _flat_matrix(dec(x.to(cuda_device)))]
            got = [c.double().cpu() for c in _flat_matrix(dec(x.to(device=cuda_device, dtype=torch.float32)))]
            assert torch.get_float32_matmul_precision() == "high"
            assert _rel_err(got, want) <= 1e-5
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("wavelet,shape,level", [("db2", (4, 2**12), 4), ("sym6", (2, 3, 100), 2), ("db4", (2, 64), None)])
def test_cuda_swt_matches_cpu(cuda_device, dtype, wavelet, shape, level):
    """``swt``/``iswt`` (plain torch ops on both devices) and a gradient."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(94), dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 2e-5

    def run(device):
        xd = x.to(device).requires_grad_()
        coeffs = tptwt.swt(xd, wavelet, level)
        rec = tptwt.iswt(coeffs, wavelet)
        loss = sum((c * (i + 1)).sum() for i, c in enumerate(coeffs)) + (rec**2).sum()
        return coeffs, rec, torch.autograd.grad(loss, xd)[0]

    coeffs, rec, grad = run(cuda_device)
    want, want_rec, want_grad = run("cpu")
    assert _rel_err([c.detach().cpu() for c in coeffs], [c.detach() for c in want]) <= tol
    assert _rel_err(rec.detach().cpu(), want_rec.detach()) <= tol
    assert _rel_err(grad.cpu(), want_grad) <= 10 * tol


# packet trees: (dim, shape, wavelet, mode, orthogonalization, separable);
# 1d on a lane past 2**16 samples takes K7 at its first levels
PACKET_CASES = [
    *((1, (3, 257), "db3", mode, "qr", False) for mode in ALL_MODES),
    (1, (2, 70001), "db5", "reflect", "qr", False),
    (1, (2, 512), "db3", "boundary", "qr", False),
    (1, (2, 300), "sym4", "boundary", "gramschmidt", False),
    *((2, (2, 45, 38), "db3", mode, "qr", sep) for mode in ALL_MODES for sep in (False, True)),
    (2, (2, 64, 64), "db2", "boundary", "qr", False),
    (2, (1, 40, 36), "db2", "boundary", "gramschmidt", True),
]


def _packet_tree(dim, x, wavelet, mode, orth, separable, level):
    if dim == 1:
        return tptwt.WaveletPacket(x, wavelet, mode=mode, maxlevel=level, orthogonalization=orth)
    return tptwt.WaveletPacket2D(x, wavelet, mode=mode, maxlevel=level, orthogonalization=orth, separable=separable)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim,shape,wavelet,mode,orth,separable", PACKET_CASES)
def test_cuda_packets_match_cpu(cuda_device, dim, shape, wavelet, mode, orth, separable, dtype):
    """Every node of a fully expanded tree, its reconstruction after
    scaling the leaves, and the gradient through it: on the card against
    the CPU plain path, every node on the card."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(95), dtype=dtype)
    tol = _tol1d(dtype)
    level = 2

    def run(device):
        xd = x.to(device).requires_grad_()
        wp = _packet_tree(dim, xd, wavelet, mode, orth, separable, level)
        order = wp.get_level(level, "natural")
        wp.initialize(order)
        nodes = {k: v.detach().clone() for k, v in wp.data.items()}
        for i, key in enumerate(order):
            wp[key] = wp[key] * (1.0 + 0.1 * i)
        try:
            wp.reconstruct()
        except AssertionError as err:  # separable periodization: as ptwt_tpu
            return nodes, err, None
        (grad,) = torch.autograd.grad((wp[""] ** 2).sum(), xd)
        return nodes, wp[""].detach(), grad

    _kernels.reset_launch_counts()
    nodes, rec, grad = run(cuda_device)
    torch.cuda.synchronize()
    launched = sum(_kernels.LAUNCHES.values())
    want, want_rec, want_grad = run("cpu")
    assert set(nodes) == set(want)
    assert all(v.device.type == "cuda" for v in nodes.values())
    assert _rel_err([nodes[k].cpu() for k in want], list(want.values())) <= tol
    assert (mode == "boundary") or launched > 0
    if isinstance(want_rec, AssertionError):
        assert isinstance(rec, AssertionError) and separable and mode == "periodization"
        return
    assert _rel_err(rec.cpu(), want_rec) <= tol
    assert _rel_err(grad.cpu(), want_grad) <= 10 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("dim,shape", [(1, (0, 64)), (2, (0, 16, 18))])
@pytest.mark.parametrize("mode", ["reflect", "periodization", "boundary"])
def test_cuda_packets_empty_batch_matches_cpu(cuda_device, dim, shape, mode):
    x = torch.zeros(shape, dtype=torch.float32)

    def run(device):
        wp = _packet_tree(dim, x.to(device), "db2", mode, "qr", False, 2)
        wp.initialize(wp.get_level(2, "natural"))
        shapes = {k: tuple(v.shape) for k, v in wp.data.items()}
        wp.reconstruct()
        return shapes, wp[""]

    shapes, rec = run(cuda_device)
    want, want_rec = run("cpu")
    assert shapes == want and tuple(rec.shape) == tuple(want_rec.shape) and rec.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["shan0.1-0.4", "mexh", "morl", "gaus3", "cgau2", "cmor1.5-1.0", "fbsp1-1.5-1.0",
                                  "db4"])
@pytest.mark.parametrize("shape", [(4, 2048), (0, 300)])
def test_cuda_cwt_matches_cpu(cuda_device, name, dtype, shape):
    """``cwt`` on cuFFT against the CPU in float64, scales spanning several
    FFT sizes; also an empty batch.  Float32 is held to 2e-5 up to scale
    30 and to a limit growing with the scale past it, as its error does
    (each coefficient differences neighbours of a long cumulative sum)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(96), dtype=dtype)
    scales = [1.0, 2.5, 7.0, 30.0, 120.0]
    got, freqs = tptwt.cwt(x.to(cuda_device), scales, name, sampling_period=0.1)
    want, want_freqs = tptwt.cwt(x.double(), scales, name, sampling_period=0.1)
    assert got.device.type == "cuda" and got.shape == want.shape
    assert got.dtype == (want.dtype if dtype == torch.float64 else tptwt.cwt(x, [1.0], name)[0].dtype)
    if x.numel():
        tol = 2e-5 if dtype == torch.float32 else 1e-10
        for g, w, s in zip(got.cpu(), want, scales):
            assert _rel_err(g.to(w.dtype), w) <= tol * max(1.0, s / 30.0)
    assert (freqs == want_freqs).all()


@pytest.mark.cuda
@pytest.mark.parametrize("params_on", ["cpu", "cuda"])
@pytest.mark.parametrize("cls", ["ShannonWavelet", "ComplexMorletWavelet"])
def test_cuda_learnable_cwt_gradients_match_cpu(cuda_device, cls, params_on):
    """The differentiable wavelets' gradients with the data on the card
    (parameters on the CPU or the card) against everything on the CPU."""
    x = torch.randn(3, 1000, generator=torch.Generator().manual_seed(97), dtype=torch.float64)
    scales = np.arange(1, 20)

    def grads(data_device, param_device):
        wav = getattr(tptwt, cls).from_frequencies(0.8, 0.6).to(param_device)
        coeffs, freqs = tptwt.cwt(x.to(data_device), scales, wav)
        loss = (coeffs.abs() ** 2).mean() + freqs.sum()
        return loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, list(wav.parameters()))]

    loss, got = grads(cuda_device, cuda_device if params_on == "cuda" else "cpu")
    want_loss, want = grads("cpu", "cpu")
    assert abs(float(loss - want_loss)) <= 1e-10 * abs(float(want_loss))
    for g, w in zip(got, want):
        assert abs(float(g - w)) <= 1e-9 * abs(float(w))


# ---------------------------------------------------------------------------
# learnable banks: the tap-gradient kernel KT and the learnable steps
# ---------------------------------------------------------------------------


def _tap_case(mode, shape, axis, taps, dtype, device, seed):
    """KT's launches of one K3 and one K4 (one and two pairs) against the
    plain versions: the largest error over each gradient's largest entry."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, dtype=dtype, generator=gen).to(device)
    dl, dh, rl, rh = (torch.randn(taps, dtype=torch.float64, generator=gen).numpy() for _ in range(4))
    ax = axis % x.ndim
    m, period, pad, code = t2._analysis_plan(x.shape[ax], taps, mode)
    band_shape = [m if i == ax else s for i, s in enumerate(shape)]
    ct = torch.randn([2, *band_shape], dtype=dtype, generator=gen).to(device)
    pairs = [(t2._tap_grad_kernel(x, ax, [ct[0]], [ct[1]], taps, period, pad, code),
              t2.dwt_axis_tap_grad_plain(x, axis, dl, dh, mode, ct))]
    if mode != "valid":
        p = 0 if mode == "periodization" else (2 * taps - 3) // 2
        circular = mode == "periodization"
        for groups in (1, 2):
            los = [torch.randn(band_shape, dtype=dtype, generator=gen).to(device) for _ in range(groups)]
            his = [torch.randn(band_shape, dtype=dtype, generator=gen).to(device) for _ in range(groups)]
            out_shape = t2.idwt_axis_plain(los[0], his[0], axis, rl, rh, p, p, mode).shape
            cot = torch.randn([groups, *out_shape], dtype=dtype, generator=gen).to(device)
            per, c = (2 * m, t2._WRAP_ZERO) if circular else (out_shape[ax], t2._ZERO)
            off = p + taps // 2 - 1 if circular else p
            pairs.append((t2._tap_grad_kernel(cot, ax + 1, los, his, taps, per, off, c),
                          t2.idwt_axis_tap_grad_plain(los, his, axis, rl, rh, p, p, mode, cot)))
    errs = []
    for got, want in pairs:
        want = torch.stack(want).double()
        errs.append(float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300))
    return max(errs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", AXIS_MODES)
@pytest.mark.parametrize("axis,shape", [(-1, (3, 5, 257)), (-2, (3, 130, 70)), (-3, (33, 4, 65))])
@pytest.mark.parametrize("taps", [8, 7])
def test_cuda_learnable_tap_kernel_matches_plain(cuda_device, dtype, mode, axis, shape, taps):
    """KT against its plain versions (autograd through the plain levels):
    every mode, axes -1/-2/-3 on odd and even lengths, an odd-length bank,
    K4's one- and two-pair launches; float32 within 1e-4 of the largest
    entry (KT sums in float64, the plain version in float32), float64
    within 1e-10."""
    err = _tap_case(mode, shape, axis, taps, dtype, cuda_device, 3)
    assert err <= (1e-4 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
def test_cuda_learnable_tap_kernel_is_reproducible(cuda_device):
    x = torch.randn(16, 1030, 1024, device=cuda_device)
    dl, dh, _, _ = _banks("db4")
    m, period, pad, code = t2._analysis_plan(1030, 8, "reflect")
    ct = torch.randn(2, 16, m, 1024, device=cuda_device)
    first = t2._tap_grad_kernel(x, 1, [ct[0]], [ct[1]], 8, period, pad, code)
    again = t2._tap_grad_kernel(x, 1, [ct[0]], [ct[1]], 8, period, pad, code)
    assert torch.equal(first, again)


def _learnable_loss(bank, x, mode):
    """The example's loss (``examples/learnable_wavelet_compression.py``):
    wavedec/waverec level 4, ``0.1 sparsity + 100 fidelity + 10 quality``."""
    coeffs = tptwt.wavedec(x, bank.filter_bank, mode=mode, level=4)
    sparsity = sum(c.abs().mean() for c in coeffs[1:])
    rec = tptwt.waverec(coeffs, bank.filter_bank)
    fidelity = ((rec[..., : x.shape[-1]] - x) ** 2).mean()
    return 0.1 * sparsity + 100.0 * fidelity + 10.0 * bank.wavelet_loss()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodic", "reflect"])
def test_cuda_learnable_steps_match_cpu(cuda_device, mode):
    """The example's workload at its width, [16, 256] float32 (unit-normal
    signals), 3 Adam steps of a SoftOrthogonalWavelet from db4 on the
    card: only K3, K4 and KT run, and each step, evaluated on the CPU at
    the card's parameters, has the card's loss within 1e-5 relative and
    its filter gradients within 1e-4 of the largest entry.  (Two free runs
    part: Adam scales the noise-level gradients of the reconstruction
    filters up to full steps.)"""
    from ptwt_tpu_torch.wavelets_learnable import SoftOrthogonalWavelet

    x = torch.randn(16, 256, generator=torch.Generator().manual_seed(0))
    bank = SoftOrthogonalWavelet.from_wavelet("db4", dtype=torch.float32).to(cuda_device)
    mirror = SoftOrthogonalWavelet.from_wavelet("db4", dtype=torch.float32)
    opt = torch.optim.Adam(bank.parameters(), lr=1e-3)
    for _ in range(3):
        with torch.no_grad():
            for p, q in zip(mirror.parameters(), bank.parameters()):
                p.copy_(q)
        opt.zero_grad()
        _kernels.reset_launch_counts()
        loss = _learnable_loss(bank, x.to(cuda_device), mode)
        loss.backward()
        torch.cuda.synchronize()
        assert {k for k, v in _kernels.LAUNCHES.items() if v} == {"K3", "K4", "KT"}
        want = _learnable_loss(mirror, x, mode)
        want_grads = torch.autograd.grad(want, list(mirror.parameters()))
        assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
        scale = max(float(g.abs().max()) for g in want_grads)
        for p, w in zip(bank.parameters(), want_grads):
            assert float((p.grad.cpu() - w).abs().max()) <= 1e-4 * scale
        opt.step()


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A (1, 1) mesh of one NCCL rank (the one card); the group is destroyed
    after the test."""
    import datetime

    import torch.distributed as dist

    from ptwt_tpu_torch.parallel import make_wavelet_mesh

    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            timeout=timeout)
    try:
        yield make_wavelet_mesh(1, 1, timeout=timeout)
    finally:
        dist.destroy_process_group()


def _tiled_leaves(coeffs):
    return [coeffs[0], *(band for level in coeffs[1:] for band in level)]


@pytest.mark.cuda
def test_cuda_tiled_wavedec2_one_nccl_rank(nccl_mesh, cuda_device):
    """t2d reflect at [2, 256, 256] on one NCCL rank: the serial port's bands
    and reconstruction, K3 twice a level and K4 twice a level."""
    from ptwt_tpu_torch.parallel import tiled_wavedec2, tiled_waverec2

    x = torch.randn(2, 256, 256, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    _kernels.reset_launch_counts()
    coeffs = tiled_wavedec2(x, "db4", level=3, mesh=nccl_mesh, mode="reflect")
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K3": 6}
    _kernels.reset_launch_counts()
    rec = tiled_waverec2(coeffs, "db4", mesh=nccl_mesh, mode="reflect").full_tensor()
    torch.cuda.synchronize()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == {"K4": 6}
    want = tptwt.wavedec2(x, "db4", mode="reflect", level=3)
    for got, ref in zip(_tiled_leaves(coeffs), _tiled_leaves(want)):
        got = got.full_tensor()
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 2e-5 * max(1.0, float(ref.abs().max()))
    assert float((rec - tptwt.waverec2(want, "db4", mode="reflect")).abs().max()) <= 2e-5
    assert float((rec - x).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_tiled_backward_one_nccl_rank(nccl_mesh, cuda_device):
    """One backward of the sum of the squared bands through t2d reflect on
    one NCCL rank against autograd through the serial port on the card."""
    from ptwt_tpu_torch.parallel import tiled_wavedec2

    x = torch.randn(2, 256, 256, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    xt = x.clone().requires_grad_()
    loss = sum((c.to_local() ** 2).sum() for c in _tiled_leaves(tiled_wavedec2(xt, "db4", level=3,
                                                                                mesh=nccl_mesh, mode="reflect")))
    loss.backward()
    xs = x.clone().requires_grad_()
    sum((c**2).sum() for c in _tiled_leaves(tptwt.wavedec2(xs, "db4", mode="reflect", level=3))).backward()
    assert float((xt.grad - xs.grad).abs().max()) <= 1e-4 * float(xs.grad.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodization", "reflect"])
def test_cuda_tiled_compile_one_nccl_rank(nccl_mesh, cuda_device, mode):
    """The t2d round trip under ``torch.compile(fullgraph=True)`` on one NCCL
    rank: no graph break, eager's launches, eager's bands and
    reconstruction bit for bit (``aot_eager`` runs the same ops)."""
    from ptwt_tpu_torch.parallel import tiled_wavedec2, tiled_waverec2

    x = torch.randn(2, 128, 96, generator=torch.Generator().manual_seed(5)).to(cuda_device)

    def round_trip(t):
        coeffs = tiled_wavedec2(t, "db4", level=3, mesh=nccl_mesh, mode=mode)
        rec = tiled_waverec2(coeffs, "db4", mesh=nccl_mesh, mode=mode)
        return [c.to_local() for c in _tiled_leaves(coeffs)], rec.to_local()

    want, eager = _counted(round_trip, x)
    torch._dynamo.reset()
    explained = torch._dynamo.explain(round_trip)(x)
    assert explained.graph_break_count == 0 and explained.graph_count == 1
    torch._dynamo.reset()
    compiled = torch.compile(round_trip, fullgraph=True, dynamic=False, backend="aot_eager")
    compiled(x)
    got, launches = _counted(compiled, x)
    assert launches == eager and eager
    for g, w in zip([*got[0], got[1]], [*want[0], want[1]]):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the reduced-precision mode: the dense-operator route
# ---------------------------------------------------------------------------

#: max-abs error against float64 over ``max(1, the band's largest
#: magnitude)`` (PERF.md §2; ``chip_smoke.py``'s phase 19 limits)
PREC_LIMITS = {"high": 3e-3, "default": 3e-2}


@pytest.fixture
def reduced(request):
    """The port's precision at one reduced level; back at ``"highest"``
    afterwards."""
    from ptwt_tpu_torch.ops import set_precision

    set_precision(request.param)
    try:
        yield request.param
    finally:
        set_precision("highest")


@pytest.mark.cuda
@pytest.mark.parametrize("reduced", ["high", "default"], indirect=True)
@pytest.mark.parametrize("mode", ["periodic", "reflect", "zero"])
def test_cuda_reduced_precision_wavedec2(cuda_device, reduced, mode):
    """Under a reduced precision every level of ``[2, 256, 256]`` (db4, 3
    levels) is a dense product: no kernel launch, bands and reconstruction
    within the level's limit of float64 (relative), different from
    ``"highest"``; the caller's global settings are unchanged."""
    from ptwt_tpu_torch.ops import set_precision

    gen = torch.Generator().manual_seed(17)
    x64 = torch.randn(2, 256, 256, generator=gen, dtype=torch.float64).to(cuda_device)
    x = x64.float()
    rec_mode = mode if mode == "periodic" else None
    want = _flat2(tptwt.wavedec2(x64, "db4", mode=mode, level=3))
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    _kernels.reset_launch_counts()
    coeffs = tptwt.wavedec2(x, "db4", mode=mode, level=3)
    rec = tptwt.waverec2(coeffs, "db4", mode=rec_mode)
    torch.cuda.synchronize()
    assert not any(_kernels.LAUNCHES.values())
    assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == saved
    got = _flat2(coeffs)
    assert all(g.dtype == torch.float32 for g in got)
    assert _rel_err([g.double() for g in got], want) <= PREC_LIMITS[reduced]
    assert _rel_err(rec.double(), x64) <= PREC_LIMITS[reduced]
    set_precision("highest")
    exact = _flat2(tptwt.wavedec2(x, "db4", mode=mode, level=3))
    assert all(float((g - e).abs().max()) > 0 for g, e in zip(got, exact))


@pytest.mark.cuda
@pytest.mark.parametrize("reduced", ["high", "default"], indirect=True)
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_cuda_axis_matmul_reduced(cuda_device, reduced, axis):
    """``axis_matmul`` on a float32 tensor at a reduced level: a float32
    result within the level's limit of float64, relative (odd lengths, so
    the operands are padded), and its backward the transposed product,
    within the same limit."""
    from ptwt_tpu_torch.ops._conv import axis_matmul

    gen = torch.Generator().manual_seed(18)
    x64 = torch.randn(3, 37, 45, 29, generator=gen, dtype=torch.float64).to(cuda_device)
    n = x64.shape[axis]
    mat64 = torch.randn(2 * n + 3, n, generator=gen, dtype=torch.float64).to(cuda_device) / math.sqrt(n)
    x = x64.float().requires_grad_()
    out = axis_matmul(x, mat64.float(), axis)
    want = axis_matmul(x64, mat64, axis)
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert _rel_err(out.detach().double(), want) <= PREC_LIMITS[reduced]
    ct = torch.randn(out.shape, generator=gen, dtype=torch.float64).to(cuda_device)
    (grad,) = torch.autograd.grad(out, x, ct.float())
    assert _rel_err(grad.double(), axis_matmul(ct, mat64.mT, axis)) <= PREC_LIMITS[reduced]


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_cuda_convs_at_highest_ignore_tf32(cuda_device, ndim):
    """``analysis_conv``/``synthesis_conv`` on float32 at ``"highest"`` with
    cuDNN's TF32 flag left on by the caller agree with float64 within
    2e-5, and leave the flag on."""
    from ptwt_tpu_torch.ops import analysis_conv, synthesis_conv
    from ptwt_tpu_torch.utils import construct_nd_filter

    dl, dh, rl, rh = _banks("db4")
    dec = construct_nd_filter(dl, dh, ndim).to(cuda_device)
    rec = construct_nd_filter(rl, rh, ndim).to(cuda_device)
    shape = {1: (64, 4096), 2: (8, 256, 256), 3: (2, 64, 64, 64)}[ndim]
    x64 = torch.randn(shape, generator=torch.Generator().manual_seed(19), dtype=torch.float64).to(cuda_device)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        bands = analysis_conv(x64.float(), dec.float())
        want = analysis_conv(x64, dec)
        assert float((bands.double() - want).abs().max()) <= 2e-5
        back = synthesis_conv(want.float(), rec.float())
        assert float((back.double() - synthesis_conv(want, rec)).abs().max()) <= 2e-5
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the ops of the kernels under torch.compile, torch.func.grad and
# torch.func.vmap (small sizes; chip_smoke.py's phase 20 runs full width)
# ---------------------------------------------------------------------------

FUNC_ROWS = {
    "2d periodic": ((4, 96, 128), lambda t: tptwt.waverec2(tptwt.wavedec2(t, "db4", mode="periodic", level=3),
                                                          "db4", mode="periodic")),
    "2d reflect": ((4, 96, 128), lambda t: tptwt.waverec2(tptwt.wavedec2(t, "db4", mode="reflect", level=3), "db4")),
    "2d periodization": ((4, 96, 128), lambda t: tptwt.waverec2(
        tptwt.wavedec2(t, "db4", mode="periodization", level=3), "db4", mode="periodization")),
    "d1": ((4, 70000), lambda t: tptwt.waverec(tptwt.wavedec(t, "db5", mode="reflect", level=6), "db5")),
    "d1 periodization": ((4, 4096), lambda t: tptwt.waverec(
        tptwt.wavedec(t, "db5", mode="periodization", level=5), "db5", mode="periodization")),
    "d3": ((2, 20, 24, 28), lambda t: tptwt.waverec3(tptwt.wavedec3(t, "db3", mode="reflect", level=2), "db3")),
    "cwt": ((4, 1000), lambda t: tptwt.cwt(t, [1.0, 2.0, 5.0, 9.0], "shan0.1-0.4")[0]),
}


def _counted(fn, *args):
    _kernels.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: v for k, v in _kernels.LAUNCHES.items() if v}


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUNC_ROWS))
def test_cuda_compile_grad_vmap_through_the_ops(cuda_device, name):
    """Compiled (inductor, one graph): eager's values within 1e-5 of
    ``max(1, |out|)`` and eager's launches; ``torch.func.grad`` against
    autograd and ``torch.func.vmap`` against the batched call within 1e-5
    of the largest entry, with the same launches."""
    shape, fn = FUNC_ROWS[name]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    want, eager = _counted(fn, x)
    torch._dynamo.reset()
    compiled = torch.compile(fn, fullgraph=True, dynamic=False)
    compiled(x)
    got, launches = _counted(compiled, x)
    assert launches == eager and (eager or name == "cwt")
    assert _rel(got, want) <= 1e-5

    def loss(t):
        return (fn(t).abs() ** 2).sum()

    g, func_launches = _counted(torch.func.grad(loss), x)
    xr = x.clone().requires_grad_()
    (ref,), auto_launches = _counted(lambda t: torch.autograd.grad(loss(t), t), xr)
    assert func_launches == auto_launches
    assert float((g - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    xs = x.reshape(2, shape[0] // 2, *shape[1:])
    v, vmap_launches = _counted(torch.func.vmap(fn), xs)
    b, batched_launches = _counted(fn, x)
    if name == "cwt":
        b = b.reshape(b.shape[0], 2, -1, b.shape[-1]).movedim(1, 0)
    assert vmap_launches == batched_launches
    assert float((v - b.reshape(v.shape)).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_reduce_overhead_headline_has_no_cudagraph_skip(cuda_device):
    """The periodic round trip under ``mode="reduce-overhead"``: one CUDA
    graph (no skip), eager's output."""
    from torch._dynamo.utils import counters

    fn = FUNC_ROWS["2d periodic"][1]
    x = torch.randn(4, 96, 128, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    want = fn(x)
    torch._dynamo.reset()
    counters.clear()
    compiled = torch.compile(fn, fullgraph=True, dynamic=False, mode="reduce-overhead")
    for _ in range(3):
        got = compiled(x)
    torch.cuda.synchronize()
    assert counters["inductor"].get("cudagraph_skips", 0) == 0
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# torch.compile over torch.func on the card: CUDA fake tensors in the trace
# (chip_smoke.py's phase 23 runs full width)
# ---------------------------------------------------------------------------


def _cubed(coeffs) -> torch.Tensor:
    from torch.utils._pytree import tree_leaves

    return sum((c**3).sum() for c in tree_leaves(coeffs))


def _compiled_like_eager(program, *args, backend="aot_eager"):
    """``program`` eager and compiled (``fullgraph=True``, one graph, no
    break): the compiled values, each leaf within 1e-12 of eager's largest
    entry (float64), and the same launches."""
    from torch._dynamo.utils import counters
    from torch.utils._pytree import tree_leaves

    want, eager = _counted(program, *args)
    torch._dynamo.reset()
    counters.clear()
    got, launches = _counted(torch.compile(program, fullgraph=True, dynamic=False, backend=backend), *args)
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    assert launches == eager and eager
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert float((g - w).abs().max()) <= 1e-12 * max(1.0, float(w.abs().max()))
    return got, launches


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["aot_eager", "inductor"])
def test_cuda_compiled_grad_of_grad(cuda_device, backend):
    """``torch.compile(torch.func.grad(|torch.func.grad(L)|^2))`` on the
    periodic headline's route at a small size (K1-K4), float64: eager
    ``torch.func``'s values and launches, and the CPU's."""
    x = torch.randn(4, 96, 128, dtype=torch.float64, generator=torch.Generator().manual_seed(5))

    def loss(t):
        return _cubed(tptwt.wavedec2(t, "db4", mode="periodic", level=3))

    program = torch.func.grad(lambda t: (torch.func.grad(loss)(t) ** 2).sum())
    got, launches = _compiled_like_eager(program, x.to(cuda_device), backend=backend)
    assert {"K1", "K2", "K3", "K4"} <= set(launches)
    _close_f64([got], [program(x)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pure", "mixed"])
def test_cuda_compiled_learnable_second_derivatives(cuda_device, kind):
    """A learnable bank's hypergradient compiled on the card, float64:
    KT, and KT's VJP on K3/K4 (``pure``), whose backward formula reads the
    cotangent's taps only when the compiled program runs; eager
    ``torch.func``'s values and launches, and the CPU's."""
    x = torch.randn(2, 40, 36, dtype=torch.float64, generator=torch.Generator().manual_seed(6))
    noise = torch.Generator().manual_seed(7)
    bank = [torch.tensor(f) + 0.01 * torch.randn(len(f), dtype=torch.float64, generator=noise)
            for f in get_filter_arrays("db3", flip=False, dtype=torch.float64)]

    def loss(fs, t):
        coeffs = tptwt.wavedec2(t, tuple(fs), mode="reflect", level=2)
        return _cubed((coeffs, tptwt.waverec2(coeffs, tuple(fs), mode="reflect")))

    grad = torch.func.grad

    def program_of(t):
        if kind == "pure":
            return grad(lambda fs: sum((g**2).sum() for g in grad(loss)(fs, t)))
        return grad(lambda fs: (grad(loss, argnums=1)(fs, t) ** 2).sum())

    got, launches = _compiled_like_eager(program_of(x.to(cuda_device)), [f.to(cuda_device) for f in bank])
    assert set(launches) == {"K3", "K4", "KT"}
    _close_f64(got, program_of(x)(bank))


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [130, 258])
@pytest.mark.parametrize("mode", ["zero", "reflect", "periodic", "symmetric", "constant", "periodization"])
def test_cuda_bank_past_the_tap_limit_matches_cpu(cuda_device, taps, mode):
    """A bank longer than ``PTWT_MAX_TAPS`` (128) on the card: K3/K4 in
    runs of taps, K1/K2 declined, 1d and 2d (an even image K1 would take
    but for the taps), float64, against the CPU plain path at 1e-10, the
    round trip, and the input's and the bank's gradients (KT per run)."""
    bank = lattice_bank(taps, taps)
    gen = torch.Generator().manual_seed(taps)
    for shape, fwd, inv in (
        ((2, 701), tptwt.wavedec, tptwt.waverec),
        ((2, 300, 264), tptwt.wavedec2, tptwt.waverec2),
    ):
        flat = list if len(shape) == 2 else _flat2
        x = torch.randn(*shape, generator=gen, dtype=torch.float64)
        _kernels.reset_launch_counts()
        got = fwd(x.to(cuda_device), bank, mode=mode, level=2)
        rec = inv(got, bank, mode=mode)
        torch.cuda.synchronize()
        assert {k for k, v in _kernels.LAUNCHES.items() if v} == {"K3", "K4"}
        want = fwd(x, bank, mode=mode, level=2)
        assert _rel_err([c.cpu() for c in flat(got)], flat(want)) <= 1e-10
        assert float((rec.cpu() - inv(want, bank, mode=mode)).abs().max()) <= 1e-10
        assert float((rec.cpu()[tuple(map(slice, shape))] - x).abs().max()) <= 1e-10

        def grads(inp, device):
            filters = [torch.tensor(f, device=device, requires_grad=True) for f in bank]
            inp = inp.to(device).requires_grad_()
            coeffs = fwd(inp, tuple(filters), mode=mode, level=2)
            loss = sum((c**2).sum() for c in flat(coeffs)) + (inv(coeffs, tuple(filters), mode=mode) ** 2).sum()
            return torch.autograd.grad(loss, [inp, *filters])

        _kernels.reset_launch_counts()
        got_grads = grads(x, cuda_device)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["KT"]
        for g, w in zip(got_grads, grads(x, "cpu")):
            assert float((g.cpu() - w).abs().max()) <= 1e-10 * max(1.0, float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "wavelet,mode,n,level",
    [("db5", "zero", 129, 4), ("sym8", "reflect", 200, 4), ("coif5", "periodic", 300, 4),
     ("db20", "constant", 300, 3), ("coif17", "symmetric", 129, 1), ("coif17", "reflect", 300, 2)],
)
def test_cuda_lowered_floor_matches_cpu(cuda_device, monkeypatch, wavelet, mode, n, level):
    """The long-lane floor lowered to 128 samples: a long filter's run on a
    signal just past it takes the deepest depth whose plan holds (K8a/K8b,
    K7a, or none), whose edge strips nearly fill the bands; float64 on the
    card against the CPU plain path, the round trip and the gradient."""
    monkeypatch.setattr(t8, "FLAT_MIN_LANES", 128)
    x = torch.randn(2, n, generator=torch.Generator().manual_seed(n + level), dtype=torch.float64)
    got = tptwt.wavedec(x.to(cuda_device), wavelet, mode=mode, level=level)
    want = tptwt.wavedec(x, wavelet, mode=mode, level=level)
    assert _rel_err([c.cpu() for c in got], want) <= 1e-10
    rec = tptwt.waverec(got, wavelet)
    assert float((rec.cpu() - tptwt.waverec(want, wavelet)).abs().max()) <= 1e-10
    xg = x.to(cuda_device).requires_grad_()
    (grad,) = torch.autograd.grad(sum((c**2).sum() for c in tptwt.wavedec(xg, wavelet, mode=mode, level=level)), xg)
    xc = x.clone().requires_grad_()
    (ref,) = torch.autograd.grad(sum((c**2).sum() for c in tptwt.wavedec(xc, wavelet, mode=mode, level=level)), xc)
    assert float((grad.cpu() - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
