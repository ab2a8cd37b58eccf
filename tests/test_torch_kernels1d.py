"""K6-K8 of ptwt_tpu_torch against the JAX package's Pallas kernels.

On the CPU each 1d kernel wrapper runs its plain torch version; here those
are held against the JAX package's kernels run in Pallas interpret mode,
called as ``tests/test_pallas.py``, ``tests/test_pallas1d.py`` and
``tests/test_pallas1d_multi.py`` call them (float32, within 2e-5, the
JAX package's float32 kernel tolerance there).  One interpret-mode call
takes seconds, so the JAX kernels run on a few cases: K8 in every padded
mode at depth 4 and in one mode at depths 2-3.

The CUDA glue of the new entry points runs on the numpy model of
``tests/test_torch_kernels.py`` (``_model_launch``), which executes the
kernels block by block with their index arithmetic: the tile cones, the
positions each block owns, the edge block's strips and mode extensions,
and the shared memory each launch asks for.  It carries the wider sweep
(every mode, depths 1-4, short and long filters), the depth-1 = K7
counting and K6's split into runs of at most four levels.  The kernels
themselves meet their plain versions on the card in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _banks, model_kernels  # noqa: F401

import ptwt_tpu as jptwt
from ptwt_tpu.ops import _pallas as j6
from ptwt_tpu.ops import _pallas1d as j7
from ptwt_tpu.ops import _pallas1d_multi as j8
import ptwt_tpu_torch as tptwt
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from _torch_one_thread import one_torch_thread  # noqa: F401

PADDED = ["zero", "reflect", "periodic", "symmetric", "constant"]
TOL32 = 2e-5


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def _signal(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _chain_crops(n, his, filt_len):
    """waverec's crops for a fused run: each step as long as the finer band."""
    return [(2 * filt_len - 3) // 2] * len(his), [n] + [h.shape[-1] for h in his[:-1]]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's Pallas kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wavelet", ["haar", "db5"])
def test_k6_matches_jax_kernel(wavelet):
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    x = _signal((2, 4096))
    taps = [tuple(float(v) for v in f) for f in (dl, dh, rl, rh)]
    want = j6._fused_wavedec1d_impl(jnp.asarray(x), taps[0], taps[1], 4)
    got = t6.fused_wavedec1d_per(torch.from_numpy(x), dl, dh, 4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w, TOL32)
    rec_want = j6._fused_waverec1d_impl(list(want), taps[2], taps[3])
    rec = t6.fused_waverec1d_per([torch.from_numpy(np.array(w)) for w in want], rl, rh)
    _close(rec, rec_want, TOL32)
    _close(rec, x, 10 * TOL32)


@pytest.mark.parametrize("mode", [*PADDED, "valid"])
def test_k7a_matches_jax_kernel(mode):
    dl, dh, _, _ = _banks("db5", np.float64)
    x = _signal((2, 70001))
    jlo, jhi = j7.flat_dwt_lane(jnp.asarray(x), dl, dh, mode)
    lo, hi = t7.flat_dwt_lane(torch.from_numpy(x), dl, dh, mode)
    _close(lo, jlo, TOL32)
    _close(hi, jhi, TOL32)


@pytest.mark.parametrize("padr_extra", [0, 1])
def test_k7b_matches_jax_kernel(padr_extra):
    dl, dh, rl, rh = _banks("db5", np.float64)
    x = _signal((2, 70001))
    lo, hi = (np.array(b) for b in j7.flat_dwt_lane(jnp.asarray(x), dl, dh, "reflect"))
    want = j7.flat_idwt_lane(jnp.asarray(lo), jnp.asarray(hi), rl, rh, 8, 8 + padr_extra)
    got = t7.flat_idwt_lane(torch.from_numpy(lo), torch.from_numpy(hi), rl, rh, 8, 8 + padr_extra)
    _close(got, want, TOL32)


@pytest.mark.parametrize(
    "mode,depth", [(m, 4) for m in PADDED] + [("reflect", 2), ("symmetric", 3)]
)
def test_k8a_matches_jax_kernel(mode, depth):
    dl, dh, _, _ = _banks("db5", np.float64)
    x = _signal((2, 70001))
    jlo, jhis = j8.flat_wavedec_lane_multi(jnp.asarray(x), dl, dh, mode, depth)
    lo, his = t8.flat_wavedec_lane_multi(torch.from_numpy(x), dl, dh, mode, depth)
    assert len(his) == len(jhis) == depth
    for g, w in zip([lo, *his], [jlo, *jhis]):
        _close(g, w, TOL32)


@pytest.mark.parametrize("depth", [2, 4])
def test_k8b_matches_jax_kernel(depth):
    dl, dh, rl, rh = _banks("db5", np.float64)
    x = _signal((2, 70001))
    lo, his = t8.multi_analysis_plain(torch.from_numpy(x), dl, dh, "periodic", depth)
    coeffs = [lo, *his[::-1]]
    pads, lens = _chain_crops(x.shape[-1], his, len(dl))
    want = j8.flat_waverec_lane_multi([jnp.asarray(c.numpy()) for c in coeffs], rl, rh, pads, lens)
    got = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
    _close(got, want, TOL32)
    _close(got, x, 10 * TOL32)


# ---------------------------------------------------------------------------
# the CUDA glue, on the numpy model of the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,wavelet,shape,level,used",
    [
        *[(m, "db5", (2, 70001), 6, "K8a K8b K3 K4") for m in PADDED],
        ("reflect", "db5", (2, 70001), 1, "K7a K7b"),
        ("symmetric", "db4", (3, 65537), 2, "K8a K8b"),
        ("periodic", "haar", (2, 70000), 4, "K8a K8b"),
        ("constant", "sym8", (1, 70003), 3, "K8a K8b"),
        ("periodization", "db5", (2, 4096), 10, "K6a K6b"),
        ("periodization", "sym4", (2, 3 * 2**9), 7, "K6a K6b"),
        # 4100 samples do not halve three times: K3/K4 level by level
        ("periodization", "db5", (2, 4100), 3, "K3 K4"),
    ],
)
def test_cuda_glue_matches_jax(model_kernels, mode, wavelet, shape, level, used):  # noqa: F811
    x = np.random.RandomState(4).randn(*shape)
    want = jptwt.wavedec(jnp.asarray(x), wavelet, mode=mode, level=level)
    got = tptwt.wavedec(torch.from_numpy(x), wavelet, mode=mode, level=level)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)
    rec_mode = mode if mode == "periodization" else None
    want_rec = jptwt.waverec(want, wavelet, mode=rec_mode)
    _close(tptwt.waverec(got, wavelet, mode=rec_mode), want_rec, 1e-10)
    assert {k for k, v in model_kernels.items() if v} == set(used.split())


def test_cuda_glue_2d_long_axis(model_kernels):  # noqa: F811
    """A 2d level whose last axis passes the gate runs K7 along it."""
    x = np.random.RandomState(5).randn(1, 6, 70001)
    want = jptwt.wavedec2(jnp.asarray(x), "db2", mode="reflect", level=1)
    got = tptwt.wavedec2(torch.from_numpy(x), "db2", mode="reflect", level=1)
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        _close(g, w, 1e-10)
    _close(tptwt.waverec2(got, "db2"), jptwt.waverec2(want, "db2"), 1e-10)
    assert model_kernels["K7a"] == 1 and model_kernels["K7b"] == 2
    assert model_kernels["K3"] == 1 and model_kernels["K4"] == 1


@pytest.mark.parametrize("mode", PADDED)
@pytest.mark.parametrize("wavelet,n", [("haar", 3001), ("db5", 4098), ("sym8", 5003), ("coif17", 9001)])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_k7_k8_glue_sweep(model_kernels, mode, wavelet, n, depth):  # noqa: F811
    """Every mode, depth and filter length on the model, against the plain
    versions (float64); a depth-1 launch counts as K7."""
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    x = torch.from_numpy(np.random.RandomState(depth).randn(2, n))
    lo, his = t8.flat_wavedec_lane_multi(x, dl, dh, mode, depth)
    ref_lo, ref_his = t8.multi_analysis_plain(x, dl, dh, mode, depth)
    for g, w in zip([lo, *his], [ref_lo, *ref_his]):
        _close(g, w.numpy(), 1e-12)
    coeffs = [ref_lo, *ref_his[::-1]]
    pads, lens = _chain_crops(n, ref_his, len(dl))
    rec = t8.flat_waverec_lane_multi(coeffs, rl, rh, pads, lens)
    _close(rec, t8.multi_synthesis_plain(coeffs, rl, rh, pads, lens).numpy(), 1e-12)
    names = ("K7a", "K7b") if depth == 1 else ("K8a", "K8b")
    assert {k for k, v in model_kernels.items() if v} == set(names)


@pytest.mark.parametrize("level", list(range(1, 11)))
def test_k6_splits_into_runs(model_kernels, level):  # noqa: F811
    """K6 runs at most four levels per launch; every launch counts."""
    dl, dh, rl, rh = _banks("db3", np.float64)
    x = torch.from_numpy(np.random.RandomState(level).randn(2, 2**11))
    got = t6.fused_wavedec1d_per(x, dl, dh, level)
    want = t6.wavedec1d_per_plain(x, dl, dh, level)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-12)
    rec = t6.fused_waverec1d_per(want, rl, rh)
    _close(rec, x.numpy(), 1e-10)
    runs = -(-level // 4)
    assert model_kernels["K6a"] == runs and model_kernels["K6b"] == runs


def test_k7_valid_and_odd_crop_glue(model_kernels):  # noqa: F811
    dl, dh, rl, rh = _banks("db3", np.float64)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 5001))
    lo, hi = t7.flat_dwt_lane(x, dl, dh, "valid")
    want = t2.dwt_axis_plain(x, -1, dl, dh, "valid")
    _close(lo, want[0].numpy(), 1e-12)
    _close(hi, want[1].numpy(), 1e-12)
    rec = t7.flat_idwt_lane(lo, hi, rl, rh, 4, 5)
    _close(rec, t2.idwt_axis_plain(lo, hi, -1, rl, rh, 4, 5, "zero").numpy(), 1e-12)
    assert model_kernels["K7a"] == 1 and model_kernels["K7b"] == 1


def test_kernel_path_refuses_grad(model_kernels):  # noqa: F811
    """On the K6, K7 and K8 routes a data tensor that requires grad gets
    its gradient from the VJP launches (K6b for K6a, the synthesis pyramid
    for K7a/K8a, counted as K7b/K8b, and the analysis pyramid for K8b,
    counted as K8a), equal to autograd through the plain versions; only a filter
    that requires grad is refused."""
    dl, dh, _, _ = _banks("db2", np.float64)
    x = torch.randn(1, 70001, dtype=torch.float64, requires_grad=True)
    cases = (
        (70001, "reflect", 4, {"K8b": 1}, lambda z: t8.multi_analysis_plain(z, dl, dh, "reflect", 4)[0]),
        (70001, "reflect", 1, {"K7b": 1}, lambda z: t2.dwt_axis_plain(z, -1, dl, dh, "reflect")[0]),
        (4096, "periodization", 3, {"K6b": 1}, lambda z: t6.wavedec1d_per_plain(z, dl, dh, 3)[0]),
    )
    for n, mode, level, vjp, plain in cases:
        loss = (tptwt.wavedec(x[:, :n], "db2", mode=mode, level=level)[0] ** 2).sum()
        _kernels.reset_launch_counts()
        (grad,) = torch.autograd.grad(loss, x)
        assert {k: v for k, v in model_kernels.items() if v} == vjp
        z = x.detach()[:, :n].requires_grad_()
        (want,) = torch.autograd.grad((plain(z) ** 2).sum(), z)
        _close(grad[:, :n], want.numpy(), 1e-12)
        assert not grad[:, n:].any()
    coeffs = tptwt.wavedec(x.detach(), "db2", mode="reflect", level=4)
    leaf = [c.requires_grad_() for c in coeffs]
    rec = tptwt.waverec(leaf, "db2")
    _kernels.reset_launch_counts()
    grads = torch.autograd.grad(rec.sum(), leaf)
    assert [g.shape for g in grads] == [c.shape for c in leaf]
    assert {k: v for k, v in model_kernels.items() if v} == {"K8a": 1}
    learn = torch.tensor(dl, requires_grad=True)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t8.flat_wavedec_lane_multi(x, learn, dh, "reflect", 4)


# ---------------------------------------------------------------------------
# the static bookkeeping and the gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [70001, 100000, 131072, 1_000_000])
@pytest.mark.parametrize("filt_len", [2, 6, 10, 16, 102])
@pytest.mark.parametrize("depth", [1, 4])
def test_interior_ranges_match_jax(n, filt_len, depth):
    """Band lengths and edge counts; the JAX plan's window coverage never
    binds here (the port's tiles cover every band)."""
    ms, spans = t8._interior_ranges(n, filt_len, depth)
    jms, jspans = j8._interior_ranges(n, filt_len, depth, 10**6)
    assert ms == jms and spans == jspans


@pytest.mark.parametrize("mode", [*PADDED, "periodization", "valid"])
def test_plan_is_held_by_the_card(mode):
    """The d1 plans fit a block's shared memory in float64; the kernels
    decline more taps than their bank holds and bands shorter than the
    edge strips."""
    depth = 1 if mode == "valid" else 4
    n = 2**20 if mode == "periodization" else 1_000_000
    for filt_len in (2, 10, 102, 128):
        ints, smem = t8._multi_plan(n, filt_len, depth, mode, 8)
        assert smem <= t8._SMEM_LIMIT
        assert ints[4] * ints[3] >= ints[8 + depth]  # the tiles cover level D
    ints, smem = t8._syn_plan(102, n, [n // 2] * 4, [100] * 4, 8)
    assert smem <= t8._SMEM_LIMIT and len(ints) == 23
    with pytest.raises(ValueError, match="taps"):
        t8._multi_plan(n, 130, 4, "reflect", 4)
    if mode in PADDED:
        with pytest.raises(ValueError, match="edge strips"):
            t8._multi_plan(100, 10, 4, mode, 4)


def test_gates():
    assert t7.flat_lane_applicable(65537, 10, "reflect")
    assert t7.flat_lane_applicable(65537, 10, "valid")
    assert not t7.flat_lane_applicable(65536, 10, "reflect")
    assert not t7.flat_lane_applicable(10**6, 10, "periodization")
    assert not t7.flat_lane_applicable(10**6, 130, "zero")
    assert t8.flat_multi_depth(10**6, 10, "periodic", 10) == 4
    assert t8.flat_multi_depth(10**6, 10, "periodic", 3) == 3
    assert t8.flat_multi_depth(10**6, 10, "periodic", 1) == 0
    assert t8.flat_multi_depth(10**6, 10, "valid", 4) == 0
    assert t8.flat_multi_depth(65536, 10, "zero", 4) == 0
    assert t8.flat_multi_syn_depth([125007, 250006, 500004, 10**6], 10, "reflect") == 4
    assert t8.flat_multi_syn_depth([10**6], 10, "reflect") == 0
    assert t8.flat_multi_syn_depth([62508, 65000], 10, "reflect") == 0
    assert t8.flat_multi_syn_depth([125007, 250006, 500004, 10**6], 10, "periodization") == 0
    assert t6.fused_wavedec_applicable(2**19, 10, 10)
    assert t6.fused_wavedec_applicable(3 * 2**5, 10, 5)
    assert not t6.fused_wavedec_applicable(100, 10, 3)
    assert not t6.fused_wavedec_applicable(64, 10, 0)
