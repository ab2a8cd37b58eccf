"""K1-K4 of ptwt_tpu_torch against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain torch version; here those
are held against the JAX package's kernels run in Pallas interpret mode
(``_pallas2d.fused2_*_level`` and ``_pallas2.pallas_*_axis``, called as
``tests/test_pallas2d.py`` and ``tests/test_pallas2.py`` call them).

The CUDA glue around the kernels (the arguments each launch gets) is
checked on the CPU too, by running it against a numpy model of the
kernels' index arithmetic.  The kernels themselves are held against their
plain versions on the card in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptwt_tpu as jptwt
import ptwt_tpu_torch as tptwt
from ptwt_tpu.ops import _pallas2 as j2
from ptwt_tpu.ops import _pallas2d as j2d
from ptwt_tpu.ops._dispatch import analysis_nd as j_analysis_nd
from ptwt_tpu.ops._dispatch import synthesis_nd as j_synthesis_nd
from ptwt_tpu.utils import get_filter_arrays as j_filters
from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d

AXIS_MODES = ["zero", "reflect", "periodic", "symmetric", "constant", "periodization", "valid"]


def _std_pad(filt_len: int) -> int:
    return (2 * filt_len - 3) // 2


def _banks(wavelet, dtype=np.float32):
    dl, dh, _, _ = j_filters(wavelet, flip=True, dtype=dtype)
    _, _, rl, rh = j_filters(wavelet, flip=False, dtype=dtype)
    return [np.asarray(f) for f in (dl, dh, rl, rh)]


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# K1 / K2: plain versions against the JAX level kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["periodization", "periodic"])
@pytest.mark.parametrize("wavelet", ["haar", "db2", "db4", "sym5"])
@pytest.mark.parametrize("shape", [(3, 16, 256), (2, 64, 256), (2, 20, 36)])
def test_fused2_level_matches_jax(shape, wavelet, mode):
    dl, dh, rl, rh = _banks(wavelet)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    p = 0 if mode == "periodization" else _std_pad(len(dl))
    if shape[-1] & (shape[-1] - 1):
        # the Pallas kernels unshuffle power-of-two axes only; the JAX
        # package's per-axis route is the reference for other shapes
        want = j_analysis_nd(jnp.asarray(x), dl, dh, mode=mode, ndim=2)
        want_rec = j_synthesis_nd(
            want, jnp.asarray(rl), jnp.asarray(rh), pads=[(p, p)] * 2, mode=mode, ndim=2
        )
    else:
        want = j2d.fused2_dwt_level(jnp.asarray(x), dl, dh, mode)
        want_rec = j2d.fused2_idwt_level(want, rl, rh, mode)
    assert t2d.fused2_analysis_applicable(shape[1], shape[2], len(dl), mode)
    got = t2d.fused2_dwt_level(torch.from_numpy(x), dl, dh, mode)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    bands = [torch.from_numpy(np.array(w)) for w in want]
    assert t2d.fused2_synthesis_applicable(*bands[0].shape[-2:], len(rl), mode, [(p, p)] * 2)
    rec = t2d.fused2_idwt_level(bands, rl, rh, mode)
    _close(rec, want_rec, 2e-5)
    _close(rec, x, 2e-5)


def test_fused2_periodic_arbitrary_coefficients():
    """K2's periodic crop is exact for coefficients that are not a wavedec
    output (thresholded)."""
    dl, dh, rl, rh = _banks("db3")
    x = jnp.asarray(np.random.RandomState(8).randn(2, 32, 256), dtype=jnp.float32)
    bands = j_analysis_nd(x, dl, dh, mode="periodic", ndim=2)
    thr = tuple(jnp.where(jnp.abs(b) > 0.7, b, 0.0) for b in bands)
    want = j2d.fused2_idwt_level(thr, rl, rh, "periodic")
    got = t2d.fused2_idwt_level([torch.from_numpy(np.array(b)) for b in thr], rl, rh, "periodic")
    _close(got, want, 2e-5)


def test_fused2_gates():
    # periodic needs an even shape; padded modes never take K1/K2
    assert t2d.fused2_analysis_applicable(20, 36, 8, "periodic")
    assert not t2d.fused2_analysis_applicable(21, 36, 8, "periodic")
    assert t2d.fused2_analysis_applicable(21, 35, 8, "periodization")
    assert not t2d.fused2_analysis_applicable(64, 64, 8, "reflect")
    # the half-size axes must cover the tap reach ((2L-3)//2 // 2 + 2)
    assert not t2d.fused2_analysis_applicable(10, 64, 8, "periodization")
    assert t2d.fused2_analysis_applicable(12, 64, 8, "periodization")
    # synthesis: standard crops only
    assert t2d.fused2_synthesis_applicable(515, 515, 8, "periodic", [(6, 6), (6, 6)])
    assert not t2d.fused2_synthesis_applicable(261, 261, 8, "periodic", [(6, 7), (6, 7)])
    assert not t2d.fused2_synthesis_applicable(32, 32, 8, "periodization", [(0, 1), (0, 0)])
    assert not t2d.fused2_synthesis_applicable(32, 32, 8, "reflect", [(6, 6), (6, 6)])


# ---------------------------------------------------------------------------
# K3 / K4: plain versions against the JAX axis kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", AXIS_MODES)
@pytest.mark.parametrize(
    "shape,axis",
    [((3, 70), -1), ((3, 70, 5), -2), ((2, 4, 33), -1), ((7, 65), -1), ((2, 516), -1)],
)
@pytest.mark.parametrize("wavelet", ["haar", "db3"])
def test_axis_kernels_match_jax(mode, shape, axis, wavelet):
    dl, dh, rl, rh = _banks(wavelet, np.float64)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jlo, jhi = j2.pallas_dwt_axis(jnp.asarray(x), axis, dl, dh, mode)
    got = t2.pallas_dwt_axis(torch.from_numpy(x), axis, dl, dh, mode)
    _close(got[0], jlo, 2e-5)
    _close(got[1], jhi, 2e-5)
    pad = 0 if mode in ("periodization", "valid") else len(dl) - 2
    want = j2.pallas_idwt_axis(jlo, jhi, axis, rl, rh, pad, pad, mode)
    lo = torch.from_numpy(np.array(jlo))
    hi = torch.from_numpy(np.array(jhi))
    rec = t2.pallas_idwt_axis([lo], [hi], axis, rl, rh, pad, pad, mode)
    _close(rec[0], want, 2e-5)


# ---------------------------------------------------------------------------
# the CUDA glue, against a numpy model of the kernels' index arithmetic
# ---------------------------------------------------------------------------


def _analysis_op(taps, m, n, period, pad, circular):
    """``[m, n]`` operator of one K1/K3 axis: ``x[wrap(2i - pad + k)]``,
    or zero outside ``[0, n)`` when not circular."""
    op = np.zeros((m, n))
    for i in range(m):
        for k, c in enumerate(taps):
            r = 2 * i - pad + k
            if circular:
                r = min(r % period, n - 1)
            elif not 0 <= r < n:
                continue
            op[i, r] += c
    return op


def _synthesis_op(taps, out_len, m, off, circular, half=None, per=None):
    """``[out_len, m]`` operator of one K2/K4 axis: ``band[(t + off - k) / 2]``.

    Circular reads go modulo ``half`` (default ``m``) and also collect the
    band rows ``+ half, + 2 half, ... < m``; positions ``t`` in
    ``[out_len, per)`` land on the last output (the K2 fold).
    """
    half = half or m
    op = np.zeros((out_len, m))
    for t in range(per or out_len):
        f = t + off
        for k in range(f & 1, len(taps), 2):
            q = (f - k) >> 1
            if circular:
                rows = range(q % half, m, half)
            elif 0 <= q < m:
                rows = [q]
            else:
                continue
            for row in rows:
                op[min(t, out_len - 1), row] += taps[k]
    return op


_BAND_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))  # (H, W) taps of ll, lh, hl, hh


def _model_launch(kernel, entry, device, dtype, *a):
    """Stand-in for ``_kernels.launch`` that runs the kernels' index rules;
    a VJP kernel runs the transpose of its forward's operator."""
    if entry in ("ptwt_analysis_axis", "ptwt_analysis_axis_t"):
        src, out, lo, hi, n_taps, outer, n, period, m, inner, pad, circ = a
        ops = [_analysis_op(t[:n_taps], m, n, period, pad, circ) for t in (lo, hi)]
        if entry == "ptwt_analysis_axis":
            xs = src.numpy().reshape(outer, n, inner)
            res = [np.einsum("mn,onj->omj", op, xs) for op in ops]
        else:
            ct = src.numpy().reshape(2, outer, m, inner)
            res = sum(np.einsum("mn,omj->onj", op, c) for op, c in zip(ops, ct))
    elif entry == "ptwt_synthesis_axis":
        lo0, hi0, lo1, hi1, groups, out, rl, rh, n_taps, outer, m, out_len, inner, off, circ = a
        s_lo = _synthesis_op(rl[:n_taps], out_len, m, off, circ)
        s_hi = _synthesis_op(rh[:n_taps], out_len, m, off, circ)
        res = [
            np.einsum("tm,omj->otj", s_lo, lo.numpy().reshape(outer, m, inner))
            + np.einsum("tm,omj->otj", s_hi, hi.numpy().reshape(outer, m, inner))
            for lo, hi in [(lo0, hi0), (lo1, hi1)][:groups]
        ]
    elif entry == "ptwt_synthesis_axis_t":
        ct, groups, out, rl, rh, n_taps, outer, m, out_len, inner, off, circ = a
        ops = [_synthesis_op(t[:n_taps], out_len, m, off, circ) for t in (rl, rh)]
        cts = ct.numpy().reshape(groups, outer, out_len, inner)
        res = [[np.einsum("tm,otj->omj", op, c) for op in ops] for c in cts]
    elif entry == "ptwt_dwt2":
        x, out, lo, hi, n_taps, b, h, w, per_h, per_w, m_h, m_w, pad, circ = a
        ops = {
            ax: [_analysis_op(t[:n_taps], m_, n_, per_, pad, circ) for t in (lo, hi)]
            for ax, m_, n_, per_ in (("h", m_h, h, per_h), ("w", m_w, w, per_w))
        }
        xs = x.numpy()
        res = [
            np.einsum("im,bmn,jn->bij", ops["h"][bh], xs, ops["w"][bw])
            for bh, bw in _BAND_TAPS
        ]
    else:  # ptwt_idwt2
        (ll, lh, hl, hh, out, lo, hi, n_taps, b, m_h, m_w, out_h, out_w, off_h, off_w,
         circ, half_h, half_w, per_h, per_w) = a
        sh = [_synthesis_op(t[:n_taps], out_h, m_h, off_h, circ, half_h, per_h) for t in (lo, hi)]
        sw = [_synthesis_op(t[:n_taps], out_w, m_w, off_w, circ, half_w, per_w) for t in (lo, hi)]
        res = sum(
            np.einsum("um,bmn,vn->buv", sh[bh], band.numpy(), sw[bw])
            for band, (bh, bw) in zip((ll, lh, hl, hh), _BAND_TAPS)
        )
    out.copy_(torch.from_numpy(np.asarray(res)).reshape(out.shape))
    _kernels.LAUNCHES[kernel] += 1


@pytest.fixture
def model_kernels(monkeypatch):
    """Send CPU tensors down the CUDA glue, launching the numpy model."""
    monkeypatch.setattr(_kernels, "launch", _model_launch)
    monkeypatch.setattr(_kernels, "check_tensor", lambda *args: None)
    monkeypatch.setattr(t2, "_on_cpu", lambda t: False)
    monkeypatch.setattr(t2d, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


@pytest.mark.parametrize(
    "shape,wavelet,mode,used",
    [
        # the headline's pattern: K1 on even levels, K3 on odd ones, K2 on
        # the standard crops, K4 on the odd crops
        ((1, 66, 70), "db3", "periodic", "K1 K2 K3 K4"),
        ((1, 40, 36), "db2", "periodic", "K1 K2 K3 K4"),
        ((2, 31, 33), "db4", "periodization", "K1 K2 K4"),
        ((1, 14, 18), "sym5", "periodization", "K1 K2 K3 K4"),
        ((2, 31, 33), "db2", "reflect", "K3 K4"),
        ((1, 20, 17), "db4", "symmetric", "K3 K4"),
        ((1, 19, 20), "haar", "zero", "K3 K4"),
        ((1, 18, 18), "bior2.2", "constant", "K3 K4"),
        # 102 taps on 37 samples: the circular reads wrap several periods
        ((1, 37, 40), "coif17", "periodization", "K3 K4"),
    ],
)
def test_cuda_glue_matches_jax(model_kernels, shape, wavelet, mode, used):
    x = np.random.RandomState(4).randn(*shape)
    want = jptwt.wavedec2(jnp.asarray(x), wavelet, mode=mode, level=2)
    got = tptwt.wavedec2(torch.from_numpy(x), wavelet, mode=mode, level=2)
    flat_w = [want[0]] + [b for t in want[1:] for b in t]
    flat_g = [got[0]] + [b for t in got[1:] for b in t]
    for g, w in zip(flat_g, flat_w):
        _close(g, w, 1e-12)
    rec_mode = mode if mode in ("periodic", "periodization") else None
    want_rec = jptwt.waverec2(want, wavelet, mode=rec_mode)
    _close(tptwt.waverec2(got, wavelet, mode=rec_mode), want_rec, 1e-12)
    assert {k for k, v in model_kernels.items() if v} == set(used.split())


def test_kernel_wrappers_refuse_grad(model_kernels):
    """On the kernel path a data tensor that requires grad gets its
    gradient from the VJP kernels; a filter that requires grad raises
    instead of falling back to the plain version."""
    x = torch.randn(1, 16, 16, dtype=torch.float64, requires_grad=True)
    dl, dh, _, _ = _banks("db2", np.float64)
    out = t2.pallas_dwt_axis(x, -1, dl, dh, "reflect")
    (grad,) = torch.autograd.grad(out.sum(), x)
    want = t2.dwt_axis_vjp_plain(x, -1, dl, dh, "reflect", torch.ones_like(out))
    _close(grad, want.numpy(), 1e-12)
    bands = t2d.fused2_dwt_level(x, dl, dh, "periodization")
    (grad,) = torch.autograd.grad(sum(b.sum() for b in bands), x)
    want = t2d.dwt2_level_vjp_plain(
        x, dl, dh, "periodization", [torch.ones_like(b) for b in bands]
    )
    _close(grad, want.numpy(), 1e-12)
    assert model_kernels["K3T"] == 1 and model_kernels["K2"] == 1
    learn = torch.tensor(dl, requires_grad=True)
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t2.pallas_dwt_axis(x.detach(), -1, learn, dh, "reflect")
    with pytest.raises(NotImplementedError, match="filter gradient"):
        t2d.fused2_dwt_level(x.detach(), learn, dh, "periodization")


def test_plain_path_carries_gradients():
    """On the CPU the plain versions are autograd-transparent, filters too."""
    w = tptwt.RegistryWavelet("db2")
    bank = [torch.tensor(f, dtype=torch.float64, requires_grad=True) for f in w.filter_bank]
    x = torch.randn(1, 12, 10, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_()

    def loss(inp, *filters):
        coeffs = tptwt.wavedec2(inp, tuple(filters), mode="reflect", level=2)
        rec = tptwt.waverec2(coeffs, tuple(filters))
        return (rec**2).sum() + sum((b**2).sum() for t in coeffs[1:] for b in t)

    assert torch.autograd.gradcheck(loss, (x, *bank))
