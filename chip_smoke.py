"""Drive ptwt_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each raising (non-zero exit) on failure:

1. the card: CUDA must be available; prints ``nvidia-smi`` name and power
   limit;
2. build: compiles the CUDA kernels of ``src/ptwt_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and prints the seconds;
3. kernels against their plain torch versions at the main path's shapes
   (db4; K1/K2 on ``[16, 1024, 1024]``, K3/K4 along both axes on the odd
   level-2 size ``[16, 515, 515]``), every boundary mode, float32 within
   2e-5 and float64 within 1e-10, plus the repo's frozen 2d goldens;
4. the main path: ``wavedec2`` -> ``waverec2`` on ``[16, 1024, 1024]``,
   db4, 4 levels, float32, in ``periodic`` (the headline) and ``reflect``
   (the default): coefficients against the plain path on the card within
   2e-5, round trip within 1e-4, launch counts read around each run;
3b. the VJP kernels against their plain versions (autograd through the
   plain versions) at the main path's shapes: K1's VJP (K2 with the fold)
   and K2's VJP (K1, zero-bounded for periodic) on ``[16, 1024, 1024]``
   <-> ``4 x 515^2`` in periodic and periodization; K3T and K4T along both
   axes of ``[16, 515, 515]`` in every mode with phase 3's odd crop; and
   coif17 on a 37-sample axis in periodization.  Unit-normal cotangents;
   float32 within 2e-5, float64 within 1e-10, and in float64 the adjoint
   identity ``<K x, y> = <x, K^T y>`` within 1e-12 of ``|K x| |y|``;
4. the main path: ``wavedec2`` -> ``waverec2`` on ``[16, 1024, 1024]``,
   db4, 4 levels, float32, in ``periodic`` (the headline) and ``reflect``
   (the default): coefficients against the plain path on the card within
   2e-5, round trip within 1e-4, launch counts read around each run;
5. times with CUDA events (3 warm-ups, median of 20): each kernel and
   each VJP, its plain version and one library call computing the same
   level (``F.conv2d`` / ``F.conv_transpose2d``, never called by the
   package), the round trip in Mpix/s, and each kernel's bound;
6. training at full width: a module holding the image ``[16, 1024,
   1024]`` and per-level, per-orientation detail gains, its loss through
   ``wavedec2`` and ``waverec2`` (db4, 4 levels, float32, periodic and
   reflect), 3 SGD steps on the kernel path against the same steps on the
   plain path on the card (losses within 1e-5 relative, first gradients
   within 1e-4 of their largest entry, the loss falls), the launches of
   one backward and of one step, the step's and the forward's wall times,
   and a profile of one step.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import ptwt_tpu_torch as ptwt  # noqa: E402
from ptwt_tpu_torch.ops import _kernels, _pallas2, _pallas2d  # noqa: E402
from ptwt_tpu_torch.utils import get_filter_arrays  # noqa: E402

DEVICE = torch.device("cuda")
SEED = 0
SHAPE = (16, 1024, 1024)
ODD = (16, 515, 515)  # level-2 input of the db4 periodic headline
WAVELET = "db4"
LEVEL = 4
TOL = {torch.float32: 2e-5, torch.float64: 1e-10}
ROUND_TRIP_TOL = 1e-4
MODES = ("reflect", "zero", "constant", "symmetric", "periodic", "periodization")

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W):
# HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

REPLACES = {
    "K1": ("src/ptwt_tpu_torch/csrc/dwt2.cu", "src/ptwt_tpu/ops/_pallas2d.py:224"),
    "K2": ("src/ptwt_tpu_torch/csrc/dwt2.cu", "src/ptwt_tpu/ops/_pallas2d.py:253"),
    "K3": ("src/ptwt_tpu_torch/csrc/axis.cu", "src/ptwt_tpu/ops/_pallas2.py:215"),
    "K4": ("src/ptwt_tpu_torch/csrc/axis.cu", "src/ptwt_tpu/ops/_pallas2.py:266"),
    "K3T": ("src/ptwt_tpu_torch/csrc/axis_vjp.cu", "src/ptwt_tpu/ops/_pallas2.py:238"),
    "K4T": ("src/ptwt_tpu_torch/csrc/axis_vjp.cu", "src/ptwt_tpu/ops/_pallas2.py:293"),
}
# K1 and K2 are each other's VJP: their VJP launches get rows of their own
VJP_ROWS = ("K1 VJP", "K2 VJP")
ADJOINT_TOL = 1e-12
COIF_SHAPE = (4, 37, 37)  # coif17's 102 taps wrap this axis several times
TRAIN_STEPS = 3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite output")
    return float((a - b).abs().max())


def check(name: str, err: float, tol: float) -> float:
    log(f"  {name}: max_abs={err!r} (tol {tol!r})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs {err!r} exceeds {tol!r}")
    return err


@contextlib.contextmanager
def plain_versions():
    """Route the kernel wrappers to their plain versions, on any device."""
    saved = (_pallas2._on_cpu, _pallas2d._on_cpu)
    _pallas2._on_cpu = _pallas2d._on_cpu = lambda t: True
    try:
        yield
    finally:
        _pallas2._on_cpu, _pallas2d._on_cpu = saved


def std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


def randn(shape, dtype, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=DEVICE, dtype=dtype)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(errors: dict) -> None:
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=dtype)
        _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=dtype)
        p = std_pad(len(dl))
        x = randn(SHAPE, dtype, SEED + 1)
        for mode in ("periodic", "periodization"):
            got = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
            ref = _pallas2d.dwt2_level_plain(x, dl, dh, mode)
            err = check(f"K1 {mode} {dtype}", max_abs(got, ref), tol)
            errors["K1"][dtype] = max(errors["K1"].get(dtype, 0.0), err)
            pp = 0 if mode == "periodization" else p
            got = _pallas2d.fused2_idwt_level(ref, rl, rh, mode)
            back = _pallas2d.idwt2_level_plain(ref, rl, rh, mode, [(pp, pp)] * 2)
            err = check(f"K2 {mode} {dtype}", max_abs(got, back), tol)
            errors["K2"][dtype] = max(errors["K2"].get(dtype, 0.0), err)
            check(f"K2(K1) {mode} round trip {dtype}", max_abs(got, x), 10 * tol)
        del x
        xo = randn(ODD, dtype, SEED + 2)
        for mode in MODES:
            for axis in (-2, -1):
                got = _pallas2.pallas_dwt_axis(xo, axis, dl, dh, mode)
                lo, hi = _pallas2.dwt_axis_plain(xo, axis, dl, dh, mode)
                err = check(
                    f"K3 {mode} axis {axis} {dtype}", max_abs(got, torch.stack((lo, hi))), tol
                )
                errors["K3"][dtype] = max(errors["K3"].get(dtype, 0.0), err)
                # the main path's odd crop: 261 -> 515 keeps one sample less
                if mode == "periodization":
                    padl, padr = 0, 2 * lo.shape[axis] - ODD[axis]
                else:
                    padl, padr = p, p + 1
                pairs = ((lo, hi), (hi, lo)) if axis == -1 else ((lo, hi),)
                got = _pallas2.pallas_idwt_axis(
                    [a for a, _ in pairs], [b for _, b in pairs], axis, rl, rh, padl, padr, mode
                )
                ref = torch.stack(
                    [
                        _pallas2.idwt_axis_plain(a, b, axis, rl, rh, padl, padr, mode)
                        for a, b in pairs
                    ]
                )
                err = check(f"K4 {mode} axis {axis} {dtype}", max_abs(got, ref), tol)
                errors["K4"][dtype] = max(errors["K4"].get(dtype, 0.0), err)
                check(f"K4(K3) {mode} axis {axis} round trip {dtype}", max_abs(got[0], xo), 10 * tol)
        del xo
        torch.cuda.synchronize()


def check_goldens() -> None:
    """Replay the repo's frozen pywt 2d goldens on the card (float64)."""
    data = np.load(ROOT / "tests" / "data" / "transform_goldens.npz")

    def signal(n):
        t = np.arange(n, dtype=np.float64)
        return np.sin(0.37 * t) + 0.05 * t + np.cos(1.7 * t + 0.5)

    image = np.outer(signal(24), signal(20)) + signal(24 * 20).reshape(24, 20)
    img = torch.as_tensor(image, device=DEVICE)
    keys = sorted({k.rsplit("/", 1)[0] for k in data.files if k.startswith("wavedec2/")})
    worst = 0.0
    for key in keys:
        _, name, mode = key.split("/")
        got = ptwt.wavedec2(img, name, mode=mode, level=2)
        flat = [got[0]] + [b for t in got[1:] for b in t]
        for i, g in enumerate(flat):
            want = torch.as_tensor(data[f"{key}/{i}"], device=DEVICE)
            worst = max(worst, max_abs(g, want))
    check(f"{len(keys)} frozen wavedec2 goldens (float64)", worst, 1e-9)


# ---------------------------------------------------------------------------
# phase 3b: the VJP kernels against their plain versions
# ---------------------------------------------------------------------------


def record(errors: dict, name: str, dtype, err: float) -> None:
    errors[name][dtype] = max(errors[name].get(dtype, 0.0), err)


def adjoint(name: str, outs, cts, ins, grads) -> None:
    """``<K x, y> = <x, K^T y>`` relative to ``|K x| |y|`` (float64)."""
    lhs = sum(float((o * c).sum()) for o, c in zip(outs, cts))
    rhs = sum(float((i * g).sum()) for i, g in zip(ins, grads))
    scale = (
        sum(float((o**2).sum()) for o in outs) * sum(float((c**2).sum()) for c in cts)
    ) ** 0.5
    check(f"{name} adjoint identity (relative)", abs(lhs - rhs) / scale, ADJOINT_TOL)


def leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


def axis_vjps(errors: dict, x, dl, dh, rl, rh, mode: str, axis: int, crop, tag: str) -> None:
    """K3T and K4T through autograd against the plain VJPs, one mode and
    axis; ``crop`` is the synthesis ``(padl, padr)``."""
    dtype = x.dtype
    tol = TOL[dtype]
    out = _pallas2.pallas_dwt_axis(x, axis, dl, dh, mode)
    ct = randn(out.shape, dtype, SEED + 20)
    (got,) = torch.autograd.grad(out, x, ct)
    ref = _pallas2.dwt_axis_vjp_plain(x, axis, dl, dh, mode, ct)
    record(errors, "K3T", dtype, check(f"K3T {tag} {dtype}", max_abs(got, ref), tol))
    if dtype == torch.float64:
        adjoint(f"K3T {tag}", [out], [ct], [x], [got])
    lo, hi = leaf(out[0]), leaf(out[1])
    pairs = ((lo, hi), (hi, lo)) if axis == -1 else ((lo, hi),)
    rec = _pallas2.pallas_idwt_axis(
        [a for a, _ in pairs], [b for _, b in pairs], axis, rl, rh, *crop, mode
    )
    ct = randn(rec.shape, dtype, SEED + 21)
    got = torch.autograd.grad(rec, (lo, hi), ct)
    ref = [torch.zeros_like(lo), torch.zeros_like(hi)]
    for (a, b), c in zip(pairs, ct):
        ga, gb = _pallas2.idwt_axis_vjp_plain(a, b, axis, rl, rh, *crop, mode, c)
        ref[0 if a is lo else 1] += ga
        ref[0 if b is lo else 1] += gb
    record(errors, "K4T", dtype, check(f"K4T {tag} {dtype}", max_abs(got, ref), tol))
    if dtype == torch.float64:
        adjoint(f"K4T {tag}", [rec], [ct], [lo, hi], got)


def check_vjps(errors: dict) -> None:
    for dtype in (torch.float32, torch.float64):
        tol = TOL[dtype]
        dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=dtype)
        _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=dtype)
        p = std_pad(len(dl))
        x = leaf(randn(SHAPE, dtype, SEED + 5))
        for mode in ("periodic", "periodization"):
            bands = _pallas2d.fused2_dwt_level(x, dl, dh, mode)
            cts = [randn(b.shape, dtype, SEED + 10 + i) for i, b in enumerate(bands)]
            (got,) = torch.autograd.grad(bands, x, cts)
            ref = _pallas2d.dwt2_level_vjp_plain(x, dl, dh, mode, cts)
            err = check(f"K1 VJP (K2) {mode} {dtype}", max_abs(got, ref), tol)
            record(errors, "K1 VJP", dtype, err)
            if dtype == torch.float64:
                adjoint(f"K1 {mode}", bands, cts, [x], [got])
            pp = 0 if mode == "periodization" else p
            subbands = [leaf(b) for b in bands]
            rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, mode)
            ct = randn(rec.shape, dtype, SEED + 14)
            got = torch.autograd.grad(rec, subbands, ct)
            ref = _pallas2d.idwt2_level_vjp_plain(subbands, rl, rh, mode, [(pp, pp)] * 2, ct)
            err = check(f"K2 VJP (K1) {mode} {dtype}", max_abs(got, ref), tol)
            record(errors, "K2 VJP", dtype, err)
            if dtype == torch.float64:
                adjoint(f"K2 {mode}", [rec], [ct], subbands, got)
            del bands, cts, subbands, rec, ct, got, ref
        del x
        xo = leaf(randn(ODD, dtype, SEED + 6))
        for mode in MODES:
            for axis in (-2, -1):
                m = (ODD[axis] + 1) // 2 if mode == "periodization" else None
                crop = (0, 2 * m - ODD[axis]) if m else (p, p + 1)
                axis_vjps(errors, xo, dl, dh, rl, rh, mode, axis, crop, f"{mode} axis {axis}")
        del xo
        # 102 taps on a 37-sample periodization axis: reads wrap several periods
        cl, ch, _, _ = get_filter_arrays("coif17", flip=True, dtype=dtype)
        _, _, crl, crh = get_filter_arrays("coif17", flip=False, dtype=dtype)
        xc = leaf(randn(COIF_SHAPE, dtype, SEED + 7))
        for axis in (-2, -1):
            axis_vjps(errors, xc, cl, ch, crl, crh, "periodization", axis, (0, 1),
                      f"coif17/37 periodization axis {axis}")
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def flat_coeffs(coeffs):
    return [coeffs[0]] + [b for t in coeffs[1:] for b in t]


def main_path(x: torch.Tensor, mode: str) -> dict:
    _kernels.reset_launch_counts()
    coeffs = ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL)
    rec = ptwt.waverec2(coeffs, WAVELET, mode=mode)
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    log(f"  {mode}: launches per round trip {counts}")
    with plain_versions():
        ref = ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL)
        ref_rec = ptwt.waverec2(ref, WAVELET, mode=mode)
    shapes = [tuple(c.shape) for c in flat_coeffs(coeffs)[:2]]
    log(f"  {mode}: cA/H shapes {shapes}")
    coeff_err = check(f"{mode} coefficients vs plain path", max_abs(flat_coeffs(coeffs), flat_coeffs(ref)), 2e-5)
    check(f"{mode} reconstruction vs plain path", max_abs(rec, ref_rec), 2e-5)
    rt_err = check(f"{mode} round trip vs input", max_abs(rec, x), ROUND_TRIP_TOL)
    return {"counts": counts, "coeff_err": coeff_err, "round_trip_err": rt_err}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events.

    A sleep kernel ahead of each timed call keeps the device busy while
    the host prepares the call, so the events bracket device work only.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median host time of one call ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def outer_filters(a, b, dtype):
    """The four outer-product filters ``[4, 1, L, L]`` in (ll, lh, hl, hh)
    order, ``lh`` = hi on H."""
    a = torch.as_tensor(np.asarray(a), dtype=dtype, device=DEVICE)
    b = torch.as_tensor(np.asarray(b), dtype=dtype, device=DEVICE)
    return torch.stack(
        [torch.outer(a, a), torch.outer(b, a), torch.outer(a, b), torch.outer(b, b)]
    )[:, None]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def analysis_flops(b: int, h: int, w: int, m_h: int, m_w: int, L: int) -> float:
    # separable minimum: W pass (lo+hi per output, h rows) then H pass on
    # both W bands; one multiply-add = 2 operations
    return 2.0 * b * (h * m_w * 2 * L + 2 * m_h * m_w * 2 * L)


def synthesis_flops(b: int, m_h: int, m_w: int, out_h: int, out_w: int, L: int) -> float:
    # each output sample of a stride-2 transposed pass takes L/2 taps from
    # each of two bands: W pass on 2 H-bands, then the H pass
    return 2.0 * b * (2 * m_h * out_w * L + out_h * out_w * L)


def time_kernels(copy_gbps: float) -> list[dict]:
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    p = std_pad(L)
    size = 4
    rows = {}

    # K1: level 1 of the periodic headline, [16, 1024, 1024] -> 4 x 515^2
    x = randn(SHAPE, f32, SEED + 3)
    b, h, w = SHAPE
    bands = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
    m = bands[0].shape[-1]
    xpad = F.pad(x[:, None], (p, p, p, p), mode="circular")
    dfilt = outer_filters(dl, dh, f32)
    lib = F.conv2d(xpad, dfilt, stride=2)
    log(f"  K1 library yardstick vs kernel max_abs={max_abs(lib.transpose(0, 1).contiguous(), torch.stack(bands))!r}")
    rows["K1"] = {
        "ms": time_ms(lambda: _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")),
        "plain_ms": time_ms(lambda: _pallas2d.dwt2_level_plain(x, dl, dh, "periodic")),
        "library_ms": time_ms(lambda: F.conv2d(xpad, dfilt, stride=2)),
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del xpad, lib

    # K2: the inverse level, 4 x 515^2 -> [16, 1024, 1024] (standard crop)
    stacked = torch.stack(bands, dim=1).contiguous()
    rfilt = outer_filters(rl, rh, f32)
    lib = F.conv_transpose2d(stacked, rfilt, stride=2)[:, 0, p:-p, p:-p]
    rec = _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic")
    log(f"  K2 library yardstick vs kernel max_abs={max_abs(lib, rec)!r}")
    rows["K2"] = {
        "ms": time_ms(lambda: _pallas2d.fused2_idwt_level(bands, rl, rh, "periodic")),
        "plain_ms": time_ms(
            lambda: _pallas2d.idwt2_level_plain(bands, rl, rh, "periodic", [(p, p)] * 2)
        ),
        "library_ms": time_ms(lambda: F.conv_transpose2d(stacked, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    del x, bands, stacked, lib, rec

    # K3: level 2 of the headline, one 2d level as two K3 passes,
    # [16, 515, 515] -> 4 x 261^2 (odd periodic)
    xo = randn(ODD, f32, SEED + 4)
    b, h, w = ODD

    def k3_level():
        rows_ = _pallas2.pallas_dwt_axis(xo, -2, dl, dh, "periodic")
        return _pallas2.pallas_dwt_axis(rows_, -1, dl, dh, "periodic")

    both = k3_level()
    m = both.shape[-1]
    xpad = F.pad(xo[:, None], (p, p + 1, p, p + 1), mode="circular")
    lib = F.conv2d(xpad, dfilt, stride=2)
    mine = torch.stack([both[0, 0], both[0, 1], both[1, 0], both[1, 1]], dim=1)
    log(f"  K3 library yardstick vs kernel max_abs={max_abs(lib, mine)!r}")
    rows["K3"] = {
        "ms": time_ms(k3_level),
        "plain_ms": time_ms(lambda: _pallas2d.dwt2_level_plain(xo, dl, dh, "periodic")),
        "library_ms": time_ms(lambda: F.conv2d(xpad, dfilt, stride=2)),
        # the level: the image read once, four bands written once
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del xpad, lib

    # K4: the inverse level, 4 x 261^2 -> [16, 515, 515] (odd crop p, p+1)
    ll, lh, hl, hh = both[0, 0], both[0, 1], both[1, 0], both[1, 1]

    def k4_level():
        cols = _pallas2.pallas_idwt_axis((ll, lh), (hl, hh), -1, rl, rh, p, p + 1, "periodic")
        return _pallas2.pallas_idwt_axis((cols[0],), (cols[1],), -2, rl, rh, p, p + 1, "periodic")[0]

    stacked = mine.contiguous()
    lib = F.conv_transpose2d(stacked, rfilt, stride=2)[:, 0, p : -(p + 1), p : -(p + 1)]
    log(f"  K4 library yardstick vs kernel max_abs={max_abs(lib, k4_level())!r}")
    rows["K4"] = {
        "ms": time_ms(k4_level),
        "plain_ms": time_ms(
            lambda: _pallas2d.idwt2_level_plain(
                (ll, lh, hl, hh), rl, rh, "periodic", [(p, p + 1)] * 2
            )
        ),
        "library_ms": time_ms(lambda: F.conv_transpose2d(stacked, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    rows.update(time_vjps())
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
        row["copy_bound_ms"] = row["bytes"] / (copy_gbps * 1e9) * 1e3
        log(
            f"  {name}: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
            f"library_ms={row['library_ms']!r} bound_ms={row['bound_ms']!r} "
            f"({row['bound_by']}) copy_bound_ms={row['copy_bound_ms']!r}"
        )
    return rows


def time_vjps() -> dict:
    """The VJP launches at the main path's shapes, each called as the
    autograd Functions' backward calls it, against autograd through the
    plain versions and one library call; the bytes are the forward twin's."""
    f32 = torch.float32
    dl, dh, _, _ = get_filter_arrays(WAVELET, flip=True, dtype=f32)
    _, _, rl, rh = get_filter_arrays(WAVELET, flip=False, dtype=f32)
    L = len(dl)
    p = std_pad(L)
    size = 4
    rows = {}
    dfilt = outer_filters(dl, dh, f32)
    rfilt = outer_filters(rl, rh, f32)

    # K1's VJP: K2 with the fold, 4 x 515^2 -> [16, 1024, 1024] (periodic)
    b, h, w = SHAPE
    x = leaf(randn(SHAPE, f32, SEED + 8))
    bands = _pallas2d.fused2_dwt_level(x, dl, dh, "periodic")
    m = bands[0].shape[-1]
    cts = torch.stack([randn(bands[0].shape, f32, SEED + 30 + i) for i in range(4)])
    fold = (h // 2, w // 2, h, w)

    def k1_vjp():
        return _pallas2d._idwt2_kernel(cts.unbind(0), dl, dh, h, w, p, True, fold)

    (auto,) = torch.autograd.grad(bands, x, tuple(cts))
    log(f"  K1 VJP timed call vs autograd max_abs={max_abs(k1_vjp(), auto)!r}")
    cts_nchw = cts.transpose(0, 1).contiguous()
    rows["K1 VJP"] = {
        "ms": time_ms(k1_vjp),
        "plain_ms": time_ms(
            lambda: _pallas2d.dwt2_level_vjp_plain(x, dl, dh, "periodic", cts.unbind(0))
        ),
        # the strided transposed convolution before its circular fold
        "library_ms": time_ms(lambda: F.conv_transpose2d(cts_nchw, dfilt, stride=2)),
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del bands, auto, cts_nchw

    # K2's VJP: K1 zero-bounded, [16, 1024, 1024] -> 4 x 515^2 (periodic)
    subbands = [leaf(c) for c in cts.unbind(0)]
    rec = _pallas2d.fused2_idwt_level(subbands, rl, rh, "periodic")
    ct = randn(rec.shape, f32, SEED + 34)

    def k2_vjp():
        return _pallas2d._dwt2_kernel(ct, rl, rh, h, w, m, m, p, False)

    auto = torch.autograd.grad(rec, subbands, ct)
    log(f"  K2 VJP timed call vs autograd max_abs={max_abs(tuple(k2_vjp()), auto)!r}")
    ct_pad = F.pad(ct[:, None], (p, p, p, p))
    lib = F.conv2d(ct_pad, rfilt, stride=2)
    log(f"  K2 VJP library yardstick vs kernel max_abs={max_abs(lib.transpose(0, 1).contiguous(), k2_vjp())!r}")
    rows["K2 VJP"] = {
        "ms": time_ms(k2_vjp),
        "plain_ms": time_ms(
            lambda: _pallas2d.idwt2_level_vjp_plain(subbands, rl, rh, "periodic", [(p, p)] * 2, ct)
        ),
        "library_ms": time_ms(lambda: F.conv2d(ct_pad, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    del x, cts, subbands, rec, ct, auto, ct_pad

    # K3T: the VJP of phase 5's K3 level (periodic, [16, 515, 515] ->
    # 4 x 261^2): K3T along the last axis, then along the first
    b, h, w = ODD
    xo = leaf(randn(ODD, f32, SEED + 9))
    rows_ = _pallas2.pallas_dwt_axis(xo, -2, dl, dh, "periodic")
    both = _pallas2.pallas_dwt_axis(rows_, -1, dl, dh, "periodic")
    m = both.shape[-1]
    ct = randn(both.shape, f32, SEED + 35)

    def k3t_level():
        g_rows = _pallas2._analysis_transpose_kernel(ct, 3, w, dl, dh, w, p, True)
        return _pallas2._analysis_transpose_kernel(g_rows, 1, h, dl, dh, h, p, True)

    (auto,) = torch.autograd.grad(both, xo, ct)
    log(f"  K3T timed level vs autograd max_abs={max_abs(k3t_level(), auto)!r}")
    ct_nchw = torch.stack([ct[0, 0], ct[0, 1], ct[1, 0], ct[1, 1]], dim=1).contiguous()

    def k3_plain_vjp():
        with torch.enable_grad():
            z = leaf(xo)
            out = _pallas2d.dwt2_level_plain(z, dl, dh, "periodic")
            return torch.autograd.grad(out, z, (ct[0, 0], ct[0, 1], ct[1, 0], ct[1, 1]))

    rows["K3T"] = {
        "ms": time_ms(k3t_level),
        "plain_ms": time_ms(k3_plain_vjp),
        "library_ms": time_ms(lambda: F.conv_transpose2d(ct_nchw, dfilt, stride=2)),
        "bytes": size * (b * h * w + 4 * b * m * m),
        "flops": analysis_flops(b, h, w, m, m, L),
    }
    del rows_, both, auto, ct_nchw

    # K4T: the VJP of phase 5's K4 level (4 x 261^2 -> [16, 515, 515],
    # odd crop p, p + 1): K4T along the first axis, then the last
    subbands = [leaf(c) for c in (ct[0, 0], ct[0, 1], ct[1, 0], ct[1, 1])]
    ll, lh, hl, hh = subbands
    cols = _pallas2.pallas_idwt_axis((ll, lh), (hl, hh), -1, rl, rh, p, p + 1, "periodic")
    lo_, hi_ = cols.unbind(0)
    rec = _pallas2.pallas_idwt_axis((lo_,), (hi_,), -2, rl, rh, p, p + 1, "periodic")
    g = randn(rec.shape, f32, SEED + 36)

    def k4t_level():
        g_cols = _pallas2._synthesis_transpose_kernel(g, 1, m, rl, rh, p, False)
        return _pallas2._synthesis_transpose_kernel(g_cols[0], 2, m, rl, rh, p, False)

    auto = torch.autograd.grad(rec, subbands, g)
    mine = k4t_level()
    log(f"  K4T timed level vs autograd max_abs={max_abs((mine[0, 0], mine[1, 0], mine[0, 1], mine[1, 1]), auto)!r}")
    # the adjoint of the transposed convolution cropped by (p, p + 1) is
    # the strided convolution of the cotangent zero-padded by (p, p + 1)
    g_pad = F.pad(g[0][:, None], (p, p + 1, p, p + 1))
    lib = F.conv2d(g_pad, rfilt, stride=2)
    log(f"  K4T library yardstick vs kernel max_abs={max_abs(lib, torch.stack([mine[0, 0], mine[1, 0], mine[0, 1], mine[1, 1]], dim=1))!r}")

    def k4_plain_vjp():
        return _pallas2d.idwt2_level_vjp_plain(
            subbands, rl, rh, "periodic", [(p, p + 1)] * 2, g[0]
        )

    rows["K4T"] = {
        "ms": time_ms(k4t_level),
        "plain_ms": time_ms(k4_plain_vjp),
        "library_ms": time_ms(lambda: F.conv2d(g_pad, rfilt, stride=2)),
        "bytes": size * (4 * b * m * m + b * h * w),
        "flops": synthesis_flops(b, m, m, h, w, L),
    }
    return rows


def profile(run, label: str) -> None:
    """Device time by kernel and the device's busy share over one call of
    ``run``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = evt.self_cuda_time_total
        rows.append((dev / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(
        f"  profiled {label}: wall {wall!r} ms (profiler on), "
        f"device busy {busy!r} ms ({100 * busy / wall:.1f}%)"
    )
    for ms, count, key in rows[:14]:
        log(f"    {ms!r} ms x{count} {key[:100]}")


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------


class GainModel(torch.nn.Module):
    """An image and per-level, per-orientation gains on its details:
    ``waverec2((cA, g[l] * details_l))`` of ``wavedec2(u)``."""

    def __init__(self, mode: str):
        super().__init__()
        self.mode = mode
        self.u = torch.nn.Parameter(randn(SHAPE, torch.float32, SEED + 40))
        self.g = torch.nn.Parameter(torch.ones(LEVEL, 3, device=DEVICE))

    def forward(self):
        coeffs = ptwt.wavedec2(self.u, WAVELET, mode=self.mode, level=LEVEL)
        details = coeffs[1:]
        scaled = [
            tuple(self.g[lev, o] * d for o, d in enumerate(t)) for lev, t in enumerate(details)
        ]
        return ptwt.waverec2((coeffs[0], *scaled), WAVELET, mode=self.mode), details


def train_loss(model: GainModel, y: torch.Tensor) -> torch.Tensor:
    rec, details = model()
    energy = sum((d**2).sum() for t in details for d in t)
    count = sum(d.numel() for t in details for d in t)
    return ((rec - y) ** 2).mean() + 1e-3 * energy / count


def optimizer(model: GainModel) -> torch.optim.SGD:
    # the image's gradient is a mean over its pixels: scale its step back up
    return torch.optim.SGD(
        [{"params": [model.u], "lr": 0.25 * model.u.numel()}, {"params": [model.g], "lr": 0.5}]
    )


def train_steps(mode: str, y: torch.Tensor) -> tuple[list, list]:
    model = GainModel(mode)
    opt = optimizer(model)
    losses, first = [], None
    for _ in range(TRAIN_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = train_loss(model, y)
        loss.backward()
        if first is None:
            first = [model.u.grad.clone(), model.g.grad.clone()]
        opt.step()
        losses.append(loss.item())
    return losses, first


def check_training(mode: str, y: torch.Tensor) -> dict:
    """3 steps on the kernel path against the plain path; launches of one
    backward and of one step; wall times and a profile of a step."""
    losses, grads = train_steps(mode, y)
    with plain_versions():
        ref_losses, ref_grads = train_steps(mode, y)
    log(f"  {mode}: losses {losses} (plain {ref_losses})")
    for got, want in zip(losses, ref_losses):
        check(f"{mode} step loss vs plain (relative)", abs(got - want) / abs(want), TRAIN_LOSS_RTOL)
    for name, got, want in zip(("u", "g"), grads, ref_grads):
        scale = float(want.abs().max())
        check(f"{mode} first-step grad {name} vs plain (/ max|grad|)", max_abs(got, want) / scale, TRAIN_GRAD_TOL)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{mode}: the loss did not fall: {losses}")

    model = GainModel(mode)
    opt = optimizer(model)
    loss = train_loss(model, y)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    backward = dict(_kernels.LAUNCHES)
    log(f"  {mode}: launches of one backward {backward}")

    def step():
        opt.zero_grad(set_to_none=True)
        train_loss(model, y).backward()
        opt.step()

    _kernels.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    per_step = dict(_kernels.LAUNCHES)
    log(f"  {mode}: launches of one training step {per_step}")
    step_ms = wall_ms(step)
    forward_ms = wall_ms(lambda: train_loss(model, y))
    log(
        f"  {mode}: training step {step_ms!r} ms wall, forward {forward_ms!r} ms, "
        f"(step - forward) / forward {(step_ms - forward_ms) / forward_ms!r}"
    )
    profile(step, f"{mode} training step")
    return {"backward": backward, "step": per_step, "step_ms": step_ms, "forward_ms": forward_ms}


def copy_bandwidth() -> float:
    """Device-to-device copy rate in GB/s (bytes read + bytes written)."""
    src = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=DEVICE)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src))
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs one GPU")
        return 1
    # exact float32: no TF32 in the library yardsticks (the package itself
    # runs no matmul or convolution)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    seconds = _kernels.build()
    log(f"build: {seconds} (wall {time.perf_counter() - t0:.1f} s)")
    for log_file in sorted(_kernels.BUILD_DIR.glob("*.log")):
        log(f"ptxas {log_file.name}: " + " | ".join(
            line.strip() for line in log_file.read_text().splitlines() if "registers" in line or "spill" in line
        ))

    log("phase 3: kernels against their plain versions")
    errors = {k: {} for k in (*REPLACES, *VJP_ROWS)}
    check_kernels(errors)
    check_goldens()
    log("phase 3b: VJP kernels against their plain versions")
    check_vjps(errors)

    log("phase 4: main path")
    x = randn(SHAPE, torch.float32, SEED)
    results = {mode: main_path(x, mode) for mode in ("periodic", "reflect")}
    per = results["periodic"]["counts"]
    for name in ("K1", "K2", "K3", "K4"):
        if per[name] < 1:
            raise AssertionError(f"{name} was not launched by the periodic round trip")
    for name in ("K3", "K4"):
        if results["reflect"]["counts"][name] < 1:
            raise AssertionError(f"{name} was not launched by the reflect round trip")

    log("phase 5: times")
    gbps = copy_bandwidth()
    log(f"  device copy: {gbps!r} GB/s")
    rows = time_kernels(gbps)
    mpix = SHAPE[0] * SHAPE[1] * SHAPE[2] / 1e6
    for mode in ("periodic", "reflect"):
        ms = wall_ms(
            lambda: ptwt.waverec2(
                ptwt.wavedec2(x, WAVELET, mode=mode, level=LEVEL), WAVELET, mode=mode
            )
        )
        log(f"  round trip {mode}: {ms!r} ms, {mpix / (ms * 1e-3)!r} Mpix/s")
    profile(
        lambda: ptwt.waverec2(
            ptwt.wavedec2(x, WAVELET, mode="periodic", level=LEVEL), WAVELET, mode="periodic"
        ),
        "periodic round trip",
    )
    del x

    log("phase 6: training at full width")
    y = randn(SHAPE, torch.float32, SEED + 41)
    train = {mode: check_training(mode, y) for mode in ("periodic", "reflect")}
    for mode, names in (("periodic", ("K1", "K2", "K3T", "K4T")), ("reflect", ("K3T", "K4T"))):
        for name in names:
            if train[mode]["backward"][name] < 1:
                raise AssertionError(f"{name} was not launched by the {mode} backward")
        for name in ("K3", "K4"):
            if train[mode]["backward"][name]:
                raise AssertionError(f"the {mode} backward launched the forward kernel {name}")
    per_step = train["periodic"]["step"]

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        row = rows[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # forward kernels: per headline round trip; VJPs: per training step
            "launches": per_step[name] if name.endswith("T") else per[name],
            "max_abs_err": errors[name][torch.float32],
            "max_abs_err_f64": errors[name][torch.float64],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "copy_bound_ms": row["copy_bound_ms"],
        }
        vjp = rows.get(f"{name} VJP")
        if vjp:
            entry.update(
                vjp_launches=train["periodic"]["backward"]["K2" if name == "K1" else "K1"],
                vjp_max_abs_err=errors[f"{name} VJP"][torch.float32],
                vjp_max_abs_err_f64=errors[f"{name} VJP"][torch.float64],
                vjp_ms=vjp["ms"],
                vjp_plain_ms=vjp["plain_ms"],
                vjp_bound_ms=vjp["bound_ms"],
                vjp_library_ms=vjp["library_ms"],
            )
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
