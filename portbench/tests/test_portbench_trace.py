"""The per-layer readers on a timeline made by hand."""

from pathlib import Path

import pytest

from portbench import trace
from portbench.metrics import (call_p95_ms, enqueue_ms, idle, kernel_ms, launches, other_device_ms,
                               roofline, throughput)
from portbench.readings import Readings

CSRC = Path(__file__).resolve().parents[2] / "src" / "ptwt_tpu_torch" / "csrc"


def _profile():
    device = [
        ("void dwt2_tile_kernel<float, 0>(float const*, float*)", 1.0, 3.0),
        ("void idwt2_tile_kernel<float, 0>(Bands2d<float>, float*)", 4.0, 6.0),
        ("void at::native::vectorized_elementwise_kernel<4>(...)", 5.0, 7.0),
        ("Memset (Device)", 8.5, 9.0),
    ]
    host = [
        (trace.CALL, 0.0, 5.0), ("aten::empty", 3.2, 3.8), (trace.FINISH, 5.0, 10.0),
        ("cudaDeviceSynchronize", 7.5, 10.0), (trace.CALL, 0.0, 0.1),
    ]
    return trace.Profile(device, host, (0.0, 10.0), 2, trace.program_kernel_names(CSRC))


def _readings(profile=None, calls=None):
    calls = calls or [(i * 0.01, i * 0.01 + 0.002, i * 0.01 + 0.008) for i in range(40)]
    return Readings(True, 5.0, 0.0, calls, [{"K1": 5, "K2": 5}] * len(calls), 1000, 2**30,
                    (2.0 * 3.35e12, 1.0), {"bytes_per_s": 3.35e12, "flops_per_s": 6.7e13}, profile)


def test_kernel_names_of_the_sources():
    names = trace.program_kernel_names(CSRC)
    assert {"dwt2_tile_kernel", "idwt2_tile_kernel", "analysis_axis_kernel", "tap_grad_kernel",
            "analysis_pyramid_kernel", "pyramid2d_synthesis_kernel"} <= names


def test_union_busy_and_idle():
    p = _profile()
    assert trace.merged(p.device, p.window) == [(1.0, 3.0), (4.0, 7.0), (8.5, 9.0)]
    assert p.busy() == pytest.approx(5.5)
    r = _readings(p)
    assert idle.read(r) == pytest.approx(45.0)
    assert kernel_ms.read(r) == pytest.approx(2e3)  # 4 s of K1/K2 over 2 calls
    assert other_device_ms.read(r) == pytest.approx(1.25e3)
    # 2 s of least time (bytes) over 2.75 s of busy per call
    assert roofline.read(r) == pytest.approx(100 * 2.0 / 2.75)


def test_the_gaps_are_named_by_the_innermost_host_event():
    out = trace.breakdown(_profile())
    gaps = dict(out["idle_gaps"])
    assert gaps[trace.CALL] == pytest.approx(1.0)  # 0-1
    assert gaps["aten::empty"] == pytest.approx(1.0)  # 3-4
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(2.5)  # 7-8.5 and 9-10
    assert trace.FINISH not in gaps
    ops = dict(out["device_ops"])
    assert ops["Memset (Device)"] == pytest.approx(0.5)


def test_window_readers():
    r = _readings()
    assert enqueue_ms.read(r) == pytest.approx(2.0)
    assert call_p95_ms.read(r) == pytest.approx(8.0)
    assert launches.read(r) == 10.0
    assert throughput.read(r) == pytest.approx(40 * 1000 / (0.39 + 0.008) / 1e6)
    assert roofline.read(_readings(None)) is None and idle.read(_readings(None)) is None
