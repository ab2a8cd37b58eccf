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
5. times with CUDA events (3 warm-ups, median of 20): each kernel, its
   plain version and one library call computing the same level
   (``F.conv2d`` / ``F.conv_transpose2d``, never called by the package),
   the round trip in Mpix/s, and each kernel's bound.

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
}


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
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


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
    img = torch.as_tensor(image, device="cuda")
    keys = sorted({k.rsplit("/", 1)[0] for k in data.files if k.startswith("wavedec2/")})
    worst = 0.0
    for key in keys:
        _, name, mode = key.split("/")
        got = ptwt.wavedec2(img, name, mode=mode, level=2)
        flat = [got[0]] + [b for t in got[1:] for b in t]
        for i, g in enumerate(flat):
            want = torch.as_tensor(data[f"{key}/{i}"], device="cuda")
            worst = max(worst, max_abs(g, want))
    check(f"{len(keys)} frozen wavedec2 goldens (float64)", worst, 1e-9)


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
    a = torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")
    b = torch.as_tensor(np.asarray(b), dtype=dtype, device="cuda")
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
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["flops"])
        row["copy_bound_ms"] = row["bytes"] / (copy_gbps * 1e9) * 1e3
        log(
            f"  {name}: ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
            f"library_ms={row['library_ms']!r} bound_ms={row['bound_ms']!r} "
            f"({row['bound_by']}) copy_bound_ms={row['copy_bound_ms']!r}"
        )
    return rows


def profile_round_trip(x: torch.Tensor) -> None:
    """Device time by kernel and the device's busy share over one periodic
    round trip, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        coeffs = ptwt.wavedec2(x, WAVELET, mode="periodic", level=LEVEL)
        return ptwt.waverec2(coeffs, WAVELET, mode="periodic")

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        f"  profiled periodic round trip: wall {wall!r} ms (profiler on), "
        f"device busy {busy!r} ms ({100 * busy / wall:.1f}%)"
    )
    for ms, count, key in rows[:12]:
        log(f"    {ms!r} ms x{count} {key[:100]}")


def copy_bandwidth() -> float:
    """Device-to-device copy rate in GB/s (bytes read + bytes written)."""
    src = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")
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
    errors = {k: {} for k in REPLACES}
    check_kernels(errors)
    check_goldens()

    log("phase 4: main path")
    x = randn(SHAPE, torch.float32, SEED)
    results = {mode: main_path(x, mode) for mode in ("periodic", "reflect")}
    per = results["periodic"]["counts"]
    for name in REPLACES:
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
    profile_round_trip(x)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        row = rows[name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": per[name],
                "max_abs_err": errors[name][torch.float32],
                "max_abs_err_f64": errors[name][torch.float64],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "copy_bound_ms": row["copy_bound_ms"],
            }
        )
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
