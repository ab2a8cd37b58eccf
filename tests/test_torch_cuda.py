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
