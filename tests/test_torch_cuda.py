"""K1-K4 of ptwt_tpu_torch against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``ptwt_tpu``, so it also runs where only the
port is installed::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import ptwt_tpu_torch as tptwt  # noqa: E402
from ptwt_tpu_torch.ops import _kernels  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,wavelet,mode",
    # valid mode needs a signal at least as long as the filter
    [(d, w, m) for d, w in CASES for m in AXIS_MODES if (w, m) != ("coif17", "valid")],
)
@pytest.mark.parametrize("axis", [-2, -1])
def test_cuda_k3_k4_match_plain(cuda_device, dtype, wavelet, mode, axis):
    dl, dh, rl, rh = _banks("db3" if wavelet == "db4" else wavelet)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    x = torch.randn(2, 37, 41, dtype=dtype, device=cuda_device)
    got = t2.pallas_dwt_axis(x, axis, dl, dh, mode)
    lo, hi = t2.dwt_axis_plain(x, axis, dl, dh, mode)
    assert float((got - torch.stack((lo, hi))).abs().max()) <= tol
    pad = 0 if mode in ("periodization", "valid") else len(dl) - 2
    rec = t2.pallas_idwt_axis([lo, hi], [hi, lo], axis, rl, rh, pad, pad + 1, mode)
    ref = [t2.idwt_axis_plain(a, b, axis, rl, rh, pad, pad + 1, mode) for a, b in ((lo, hi), (hi, lo))]
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
# the VJP kernels: K3T, K4T, and K1 / K2 as each other's VJP
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,wavelet,mode",
    [(d, w, m) for d, w in CASES for m in AXIS_MODES if (w, m) != ("coif17", "valid")],
)
@pytest.mark.parametrize("axis", [-2, -1])
def test_cuda_k3t_k4t_match_plain(cuda_device, dtype, wavelet, mode, axis):
    dl, dh, rl, rh = _banks("db3" if wavelet == "db4" else wavelet)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    x = torch.randn(2, 37, 41, dtype=dtype, device=cuda_device, requires_grad=True)
    out = t2.pallas_dwt_axis(x, axis, dl, dh, mode)
    ct = _randn_like(out, 1)
    _kernels.reset_launch_counts()
    (grad,) = torch.autograd.grad(out, x, ct)
    want = t2.dwt_axis_vjp_plain(x, axis, dl, dh, mode, ct)
    assert float((grad - want).abs().max()) <= tol
    assert _kernels.LAUNCHES["K3T"] == 1
    lo, hi = (b.detach().requires_grad_() for b in out)
    pad = 0 if mode in ("periodization", "valid") else len(dl) - 2
    rec = t2.pallas_idwt_axis([lo, hi], [hi, lo], axis, rl, rh, pad, pad + 1, mode)
    ct = _randn_like(rec, 2)
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, (lo, hi), ct)
    want = [t2.idwt_axis_vjp_plain(a, b, axis, rl, rh, pad, pad + 1, mode, c)
            for (a, b), c in zip(((lo, hi), (hi, lo)), ct)]
    # lo and hi each feed both groups, once as lo and once as hi
    assert float((got[0] - (want[0][0] + want[1][1])).abs().max()) <= 2 * tol
    assert float((got[1] - (want[0][1] + want[1][0])).abs().max()) <= 2 * tol
    assert _kernels.LAUNCHES["K4T"] == 1


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
        return torch.autograd.grad(loss, xd)[0]

    _kernels.reset_launch_counts()
    got = grad_on(cuda_device)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K3T"] + _kernels.LAUNCHES["K4T"] > 0
    assert float((got.cpu() - grad_on("cpu")).abs().max()) <= 1e-11


@pytest.mark.cuda
def test_cuda_filter_grad_and_double_backward_raise(cuda_device):
    x = torch.randn(1, 32, 32, dtype=torch.float64, device=cuda_device, requires_grad=True)
    dl, dh, _, _ = _banks("db2")
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t2.pallas_dwt_axis(x, -1, torch.tensor(dl, requires_grad=True), dh, "reflect")
    out = t2.pallas_dwt_axis(x, -1, dl, dh, "reflect")
    (grad,) = torch.autograd.grad((out**2).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(grad.sum(), x)
