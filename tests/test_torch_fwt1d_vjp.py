"""The VJPs of K7/K8 as pyramid launches, against the JAX package.

The backward of a K8a (K7a) launch is one launch of the synthesis pyramid
kernel of ``csrc/fwt1d.cu`` with the padding fold in an edge block, and
the backward of a K8b (K7b) launch one launch of the analysis pyramid
kernel, zero-bounded.  Here that glue runs on the CPU against the numpy
model of the kernels (``model_kernels`` of ``tests/test_torch_kernels.py``,
which replays both kernels block by block, edge blocks, strips and folds
included), and its gradients are held against ``jax.vjp``:

* through ``ptwt_tpu``'s own ``flat_wavedec_lane_multi`` /
  ``flat_waverec_lane_multi`` and the K7 pair ``flat_dwt_lane`` /
  ``flat_idwt_lane``, their Pallas forwards in interpret mode as the JAX
  package's tests run them on the CPU;
* and, over every padded mode and ``valid``, depth 1-4, odd and even
  lengths just above ``FLAT_MIN_LANES`` and filters of 2, 10 and 102
  taps, through the JAX package's per-level convolution route
  (``fwt_pad`` and ``analysis_conv`` / ``synthesis_conv``), the same
  linear maps those kernels' custom VJPs transpose, and defined where the
  JAX fused plan declines a long filter.

Tolerances: float32 5e-5 relative to ``max(1, |band|)``, float64 1e-10;
the float64 adjoint identity within 1e-12 of ``|Kx||y|``.  Every forward
plan the kernels accept has VJP plans, and one backward launches exactly
one pyramid kernel (no per-axis K3/K4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _banks, model_kernels  # noqa: F401

from ptwt_tpu.ops import _pallas1d as j7
from ptwt_tpu.ops import _pallas1d_multi as j8
from ptwt_tpu.ops._conv import analysis_conv, synthesis_conv
from ptwt_tpu.utils import fwt_pad
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from _torch_one_thread import one_torch_thread  # noqa: F401

PADDED = ["zero", "reflect", "periodic", "symmetric", "constant"]
N_ODD, N_EVEN = t8.FLAT_MIN_LANES + 1, t8.FLAT_MIN_LANES + 2
TOL = {np.float32: 5e-5, np.float64: 1e-10}


def _rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _used(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def _crops(filt_len: int, n: int, his):
    """waverec's crops of a fused run: each step as long as the finer band."""
    return [(2 * filt_len - 3) // 2] * len(his), [n] + [h.shape[-1] for h in his[:-1]]


def _jax_analysis(dl, dh, mode: str, depth: int):
    """``depth`` levels of the JAX package's convolution route."""
    filt = jnp.stack([jnp.asarray(dl), jnp.asarray(dh)])[:, None]

    def run(x):
        lo, his = x, []
        for _ in range(depth):
            ext = lo if mode == "valid" else fwt_pad(lo, len(dl), mode=mode)
            bands = analysis_conv(ext, filt.astype(x.dtype))
            lo, h = bands[:, 0], bands[:, 1]
            his.append(h)
        return lo, his

    return run


def _jax_synthesis(rl, rh, pads, lens):
    """The synthesis steps of the JAX package's convolution route, each
    cropped to ``lens`` by ``pads`` (fine to coarse)."""
    filt = jnp.stack([jnp.asarray(rl), jnp.asarray(rh)])[:, None]

    def run(*coeffs):
        cur = coeffs[0]
        depth = len(coeffs) - 1
        for step in range(depth):
            lvl = depth - step
            full = synthesis_conv(jnp.stack([cur, coeffs[1 + step]], axis=1), filt.astype(cur.dtype))
            cur = full[:, pads[lvl - 1] : pads[lvl - 1] + lens[lvl - 1]]
        return cur

    return run


def _adjoint(outs, cts, ins, grads) -> None:
    lhs = sum(float((o.detach().double() * c.double()).sum()) for o, c in zip(outs, cts))
    rhs = sum(float((i.detach().double() * g.double()).sum()) for i, g in zip(ins, grads))
    scale = np.sqrt(sum(float((o.detach().double() ** 2).sum()) for o in outs))
    scale *= np.sqrt(sum(float((c.double() ** 2).sum()) for c in cts))
    assert abs(lhs - rhs) <= 1e-12 * scale


def _round_trip_vjps(counts, x_np, wavelet, mode, depth, dtype, jax_analysis, jax_synthesis):
    """Both VJPs of one fused run on the model against ``jax.vjp`` of the
    given JAX forwards; returns the kernels' gradients and cotangents."""
    dl, dh, rl, rh = _banks(wavelet, dtype)
    rng = np.random.RandomState(x_np.shape[-1] + depth)
    x = torch.from_numpy(x_np).requires_grad_()
    kernel_a, kernel_b = ("K7a", "K7b") if depth == 1 else ("K8a", "K8b")
    lo, his = t8.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
    outs = [lo, *his]
    cts = [torch.from_numpy(rng.randn(*t.shape).astype(dtype)) for t in outs]
    _kernels.reset_launch_counts()
    (got,) = torch.autograd.grad(outs, x, cts)
    assert _used(counts) == {kernel_b: 1}
    (j_lo, j_his), vjp = jax.vjp(jax_analysis(dl, dh, mode, depth), jnp.asarray(x_np))
    (want,) = vjp((jnp.asarray(cts[0].numpy()), [jnp.asarray(c.numpy()) for c in cts[1:]]))
    assert _rel(got, want) <= TOL[dtype]
    if dtype == np.float64:
        _adjoint(outs, cts, [x], [got])
    if mode == "valid":
        return
    coeffs_np = [np.asarray(c) for c in (j_lo, *j_his[::-1])]
    pads, lens = _crops(len(dl), x_np.shape[-1], j_his)
    coeffs = [torch.from_numpy(c.copy()).requires_grad_() for c in coeffs_np]
    rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
    ct = torch.from_numpy(rng.randn(*rec.shape).astype(dtype))
    _kernels.reset_launch_counts()
    got = torch.autograd.grad(rec, coeffs, ct)
    assert _used(counts) == {kernel_a: 1}
    _, vjp = jax.vjp(jax_synthesis(rl, rh, pads, lens), *[jnp.asarray(c) for c in coeffs_np])
    for g, w in zip(got, vjp(jnp.asarray(ct.numpy()))):
        assert _rel(g, w) <= TOL[dtype]
    if dtype == np.float64:
        _adjoint([rec], [ct], coeffs, got)


# ---------------------------------------------------------------------------
# through the JAX package's own K7/K8 (Pallas in interpret mode)
# ---------------------------------------------------------------------------


def _j8_analysis(dl, dh, mode, depth):
    return lambda x: j8.flat_wavedec_lane_multi(x, dl, dh, mode, depth)


def _j8_synthesis(rl, rh, pads, lens):
    return lambda *c: j8.flat_waverec_lane_multi(list(c), rl, rh, pads, lens)


def _j7_analysis(dl, dh, mode, depth):
    def run(x):
        lo, hi = j7.flat_dwt_lane(x, dl, dh, mode)
        return lo, [hi]

    return run


def _j7_synthesis(rl, rh, pads, lens):
    def run(lo, hi):
        padr = 2 * (hi.shape[-1] - 1) + len(rl) - pads[0] - lens[0]
        return j7.flat_idwt_lane(lo, hi, rl, rh, pads[0], padr)

    return run


@pytest.mark.parametrize(
    "mode,depth,wavelet,n,dtype",
    [("reflect", 4, "db5", N_ODD, np.float32), ("periodic", 3, "haar", N_EVEN, np.float64)],
)
def test_k8_vjps_match_jax_kernels(model_kernels, mode, depth, wavelet, n, dtype):  # noqa: F811
    x = np.random.RandomState(depth).randn(2, n).astype(dtype)
    _round_trip_vjps(model_kernels, x, wavelet, mode, depth, dtype, _j8_analysis, _j8_synthesis)


@pytest.mark.parametrize(
    "mode,wavelet,n,dtype",
    [
        ("symmetric", "db5", N_ODD, np.float64),
        ("zero", "haar", N_EVEN, np.float32),
        ("valid", "db5", N_ODD, np.float64),
    ],
)
def test_k7_vjps_match_jax_kernels(model_kernels, mode, wavelet, n, dtype):  # noqa: F811
    x = np.random.RandomState(7).randn(2, n).astype(dtype)
    _round_trip_vjps(model_kernels, x, wavelet, mode, 1, dtype, _j7_analysis, _j7_synthesis)


# ---------------------------------------------------------------------------
# every mode, depth 1-4, against the per-level route the JAX VJPs transpose
# ---------------------------------------------------------------------------

_SWEEP = [
    (mode, depth, ("haar", "db5")[(i + depth) % 2], (N_ODD, N_EVEN)[(i + depth // 2) % 2])
    for i, mode in enumerate(PADDED)
    for depth in (1, 2, 3, 4)
] + [
    # the longest registry filter (102 taps) at both ends of the depth range
    ("reflect", 4, "coif17", N_ODD),
    ("periodic", 1, "coif17", N_EVEN),
    ("constant", 4, "coif17", N_EVEN),
    ("valid", 1, "coif17", N_ODD),
    ("valid", 1, "haar", N_EVEN),
]


@pytest.mark.parametrize("mode,depth,wavelet,n", _SWEEP)
def test_vjps_match_jax_per_level(model_kernels, mode, depth, wavelet, n):  # noqa: F811
    x = np.random.RandomState(n + depth).randn(2, n)
    _round_trip_vjps(model_kernels, x, wavelet, mode, depth, np.float64, _jax_analysis, _jax_synthesis)


@pytest.mark.parametrize("mode", PADDED)
def test_vjps_on_the_shortest_signal(model_kernels, mode):  # noqa: F811
    """The shortest odd signal the forward plan takes at depth 4: bands
    barely longer than their strips, where symmetric and reflect fold
    several preimages onto one position and constant folds every left pad
    onto position 0."""
    n = _shortest(10, 4, mode) | 1
    x = np.random.RandomState(n).randn(2, n)
    _round_trip_vjps(model_kernels, x, "db5", mode, 4, np.float64, _jax_analysis, _jax_synthesis)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


def _shortest(filt_len: int, depth: int, mode: str) -> int:
    """The shortest signal the forward K8a plan takes."""
    n = 2
    while True:
        try:
            t8._multi_plan(n, filt_len, depth, mode, 8)
            return n
        except ValueError:
            n += 1


@pytest.mark.parametrize("mode", [*PADDED, "valid"])
def test_every_forward_plan_has_vjp_plans(mode):
    """Item by item over the plan domain: filter lengths 2-128, depth 1-4
    (``valid``: 1), both dtypes, the shortest accepted signal and longer
    ones; wherever the forward analysis plan is accepted, the plan of its
    VJP (the synthesis kernel with the fold) is too, and so are the
    synthesis plan of waverec's crops and its VJP's (the analysis kernel,
    zero-bounded)."""
    depths = (1,) if mode == "valid" else (1, 2, 3, 4)
    for filt_len in (2, 3, 10, 31, 64, 102, 127, 128):
        pad = 0 if mode == "valid" else (2 * filt_len - 3) // 2
        fold = mode if mode in PADDED else None
        for depth in depths:
            n0 = _shortest(filt_len, depth, mode) if fold else filt_len
            for n in (n0, n0 + 1, n0 + 37, N_ODD, 1_000_000):
                for itemsize in (4, 8):
                    ints, smem = t8._multi_plan(n, filt_len, depth, mode, itemsize)
                    ms = ints[8 : 9 + depth]
                    assert smem <= t8._SMEM_LIMIT
                    syn, smem = t8._syn_plan(filt_len, n, list(ms[1:]), [pad] * depth, itemsize, fold)
                    assert smem <= t8._SMEM_LIMIT and syn[2] * syn[1] >= n
                    if fold:
                        wz, strips = syn[16], syn[18 : 19 + depth]
                        assert wz <= strips[0] and all(1 <= e <= m for e, m in zip(strips, ms))
                    if mode == "valid":
                        continue
                    ints, smem = t8._adjoint_plan(filt_len, n, list(ms[1:]), [pad] * depth, itemsize)
                    assert smem <= t8._SMEM_LIMIT and ints[8 : 9 + depth] == [n, *ms[1:]]


def test_backward_launches_one_pyramid_kernel(model_kernels):  # noqa: F811
    """One backward of each fused launch is one launch of the other pyramid
    kernel under its counterpart's name: no per-axis K3/K4, no per-level loop."""
    dl, dh, rl, rh = _banks("db5", np.float64)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, N_ODD)).requires_grad_()
    for depth, (fwd, vjp) in ((1, ("K7a", "K7b")), (4, ("K8a", "K8b"))):
        lo, his = t8.flat_wavedec_lane_multi(x, dl, dh, "reflect", depth)
        _kernels.reset_launch_counts()
        torch.autograd.grad((lo.sum() + sum(h.sum() for h in his)), x)
        assert _used(model_kernels) == {vjp: 1}
        coeffs = [t.detach().requires_grad_() for t in (lo, *his[::-1])]
        pads, lens = _crops(len(dl), N_ODD, his)
        rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
        _kernels.reset_launch_counts()
        torch.autograd.grad(rec.sum(), coeffs)
        assert _used(model_kernels) == {fwd: 1}
    lo, hi = t7.flat_dwt_lane(x, dl, dh, "valid")
    _kernels.reset_launch_counts()
    torch.autograd.grad(lo.sum() + hi.sum(), x)
    assert _used(model_kernels) == {"K7b": 1}
