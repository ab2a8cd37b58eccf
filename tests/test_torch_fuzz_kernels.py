"""Randomized guards of ptwt_tpu_torch, part 3: every kernel's gate.

The counterparts of ``tests/test_fuzz.py``'s forced dispatch
(``test_fuzz_pallas2_forced_dispatch``) and forced multi-level fusion
(``test_fuzz_multi_level_fusion``, slow there and here).  The JAX test
lowers ``pallas_axis_applicable`` and ``flat_multi_depth`` so that small
shapes reach its Pallas kernels; here the port's own gates are lowered
(the long-lane floor ``FLAT_MIN_LANES`` of ``ops/_pallas1d_multi.py``,
the matrix transforms' long-axis cutoff), so that small float32 draws
reach K1-K9 and KT on the kernel route (the CUDA glue on the numpy kernel
model, ``tests/_torch_fuzz.py``).  ``ptwt_tpu`` runs its default route on
the same input.  Every coefficient leaf agrees within 2e-5 of ``max(1,
|leaf|)``, the round trip within 5e-4 as in ``tests/test_fuzz.py``, and
the input's gradient of the squared coefficients (a learnable bank's too)
within 1e-4 of its largest entry against the plain route.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import pytest
import torch
from _torch_fuzz import (  # noqa: F401
    compare_leaves,
    crop,
    fuzz_kernels,
    grad_close,
    jax_round_trip,
    launched,
    leaves,
    plain_route,
    run_draws,
)

import ptwt_tpu as jp
import ptwt_tpu_torch as tp
from _torch_banks import lattice_bank
from _torch_one_thread import one_torch_thread  # noqa: F401
from ptwt_tpu import matmul_transform as jmt
from ptwt_tpu.ops import set_long_boundary_cutoff as j_set_cutoff
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import long_boundary_cutoff, set_long_boundary_cutoff

MODES = ["zero", "reflect", "periodic", "symmetric", "constant", "periodization"]
#: A user's bank longer than the kernels' tap limit (``PTWT_MAX_TAPS`` = 128).
LONG_BANK = lattice_bank(130, 22)
WAVELETS = ["haar", "db2", "db3", "sym4", "bior2.2", LONG_BANK]
ORTHOGONAL = ["haar", "db2", "db3", "sym4"]
REL_TOL = 2e-5
ROUND_TRIP_TOL = 5e-4
GRAD_TOL = 1e-4
#: The lowered long-lane floor: 1d draws of 32 to 512 samples straddle it.
FLOOR = 128
#: The lowered long-axis cutoff of the matrix transforms.
CUTOFF = 64
MXU2D_ENV = "PTWT_TPU_MXU2D"
#: K9's smallest image (``h % 128 == 0``, ``w % 256 == 0``).
K9_SHAPE = (128, 256)

#: Kernels launched by each test's draws.
SEEN: dict = collections.defaultdict(collections.Counter)


@pytest.fixture
def lowered(monkeypatch):
    """Lower the port's long-lane floor and both packages' long-axis
    cutoff; keep the JAX matrix transforms' long levels per level (their
    fused runs need the TPU window kernels)."""
    monkeypatch.setattr(t8, "FLAT_MIN_LANES", FLOOR)
    monkeypatch.delenv(MXU2D_ENV, raising=False)
    monkeypatch.setattr(jmt, "long_run_depth", lambda *a: 0)
    monkeypatch.setattr(jmt, "long_syn_run_depth", lambda *a: 0)
    old = long_boundary_cutoff()
    set_long_boundary_cutoff(CUTOFF)
    j_set_cutoff(CUTOFF)
    yield monkeypatch
    set_long_boundary_cutoff(old)
    j_set_cutoff(old)


def _sum_squares(coeffs) -> torch.Tensor:
    return sum((leaf**2).sum() for leaf in leaves(coeffs))


def _check_draw(what, forward, inverse, x, jax_forward, jax_inverse, bank=None) -> dict:
    """One draw: the kernel route's leaves and round trip against
    ``ptwt_tpu``, then the gradient of the squared coefficients and
    reconstruction (the input's, and a learnable ``bank``'s) against the
    plain route.  Returns the kernels it launched."""
    want, rec_want = jax_round_trip(jax_forward, jax_inverse, x)
    got = forward(torch.from_numpy(x), bank)
    compare_leaves(got, want, REL_TOL, what, relative=True)
    rec = inverse(got, bank)
    compare_leaves([rec], [rec_want], REL_TOL, what + " rec", relative=True)
    np.testing.assert_allclose(crop(rec.detach().numpy(), x.shape), x, atol=ROUND_TRIP_TOL, rtol=0, err_msg=what)
    def gradients():
        inp = torch.from_numpy(x).requires_grad_()
        coeffs = forward(inp, bank)
        loss = _sum_squares(coeffs) + _sum_squares(inverse(coeffs, bank))
        return torch.autograd.grad(loss, [inp, *(bank or ())])

    grads = [gradients()]
    counts = launched()
    with plain_route():
        grads.append(gradients())
    for i, (g, w) in enumerate(zip(*grads)):
        grad_close(g, w, GRAD_TOL, f"{what} gradient {i}")
    return counts


def _filter_bank(wavelet) -> tuple:
    return wavelet if isinstance(wavelet, tuple) else tp.RegistryWavelet(wavelet).filter_bank


def _learnable(wavelet):
    """``wavelet``'s bank as float32 tensors that require grad."""
    return tuple(torch.tensor(np.asarray(f), dtype=torch.float32, requires_grad=True) for f in _filter_bank(wavelet))


def test_fuzz_pallas2_forced_dispatch(fuzz_kernels, lowered):  # noqa: F811
    def draw(rng, trial):
        mode = MODES[rng.randint(len(MODES))]
        wavelet = WAVELETS[rng.randint(len(WAVELETS))]
        filt_len = len(_filter_bank(wavelet)[0])
        name = f"{filt_len}-tap bank" if isinstance(wavelet, tuple) else wavelet
        bank = _learnable(wavelet) if rng.randint(5) == 0 else None  # KT
        kind = trial % 5
        if kind < 2:  # 1d, odd lengths or halving chains around the floor
            n = int(rng.randint(32, 4 * FLOOR))
            if rng.randint(2):
                n -= n % 16
            level = int(rng.randint(1, max(1, min(4, tp.dwt_max_level(n, filt_len))) + 1))
            x = rng.randn(2, n).astype(np.float32)
            fwd = lambda t, b: tp.wavedec(t, b or wavelet, mode=mode, level=level)  # noqa: E731
            inv = lambda c, b: tp.waverec(c, b or wavelet, mode=mode)  # noqa: E731
            jfwd = lambda t: jp.wavedec(t, wavelet, mode=mode, level=level)  # noqa: E731
            jinv = lambda c: jp.waverec(c, wavelet, mode=mode)  # noqa: E731
            what = f"{trial} 1d {n} {name} {mode} L={level}"
        elif kind == 4:  # the matrix transforms past the lowered cutoff
            n = 16 * int(rng.randint(10, 40))
            level = int(rng.randint(2, 5))
            wavelet = ORTHOGONAL[rng.randint(len(ORTHOGONAL))]  # the boundary wavelets need one
            x = rng.randn(2, n).astype(np.float32)
            bank = None  # the matrix transforms refuse a bank that requires grad
            dec, jdec = tp.MatrixWavedec(wavelet, level), jp.MatrixWavedec(wavelet, level)
            rec, jrec = tp.MatrixWaverec(wavelet), jp.MatrixWaverec(wavelet)
            fwd, inv = (lambda t, b: dec(t)), (lambda c, b: rec(c))
            jfwd, jinv = jdec, jrec
            name = wavelet
            what = f"{trial} matrix {n} {wavelet} L={level}"
        else:  # 2d, odd shapes, halving chains, K9's images with its opt-in
            h, w = int(rng.randint(24, 80)), int(rng.randint(24, 80))
            opt_in = kind == 3 and rng.randint(2)
            if opt_in:
                (h, w), mode = K9_SHAPE, "periodic"
            elif rng.randint(2):
                h, w = h - h % 8, w - w % 8
            level = int(rng.randint(1, max(1, min(3, tp.dwt_max_level(min(h, w), filt_len))) + 1))
            x = rng.randn(2, h, w).astype(np.float32)
            if opt_in:
                lowered.setenv(MXU2D_ENV, "1")
            fwd = lambda t, b: tp.wavedec2(t, b or wavelet, mode=mode, level=level)  # noqa: E731
            inv = lambda c, b: tp.waverec2(c, b or wavelet, mode=mode)  # noqa: E731
            jfwd = lambda t: jp.wavedec2(t, wavelet, mode=mode, level=level)  # noqa: E731
            jinv = lambda c: jp.waverec2(c, wavelet, mode=mode)  # noqa: E731
            what = f"{trial} 2d {h}x{w} {name} {mode} L={level}{' K9 opt-in' if opt_in else ''}"
        what += " learnable" if bank else ""
        SEEN["forced"].update(_check_draw(what, fwd, inv, x, jfwd, jinv, bank))
        lowered.delenv(MXU2D_ENV, raising=False)

    run_draws(40, 1234, draw)
    missed = set(fuzz_kernels) - set(SEEN["forced"])  # every kernel: K1-K9 and KT
    assert not missed, f"the draws launched {dict(SEEN['forced'])}, not {sorted(missed)}"


@pytest.mark.slow
def test_fuzz_multi_level_fusion(fuzz_kernels, monkeypatch):  # noqa: F811
    """Long float32 signals through the fused multi-level runs K8a/K8b
    (and K7 where one long level is left), the long-lane floor lowered to
    40000 samples as the JAX test forces its runs above 40000."""
    monkeypatch.setattr(t8, "FLAT_MIN_LANES", 40000)
    modes = ["zero", "reflect", "periodic", "symmetric", "constant"]

    def draw(rng, trial):
        n = int(rng.randint(50000, 120000))
        wavelet = ["haar", "db3", "db7", "sym5", "coif2"][trial % 5]
        mode = modes[trial % 5]
        level = int(rng.randint(2, 7))
        x = rng.randn(2, n).astype(np.float32)
        what = f"{trial} {n} {wavelet} {mode} L={level}"
        want, rec_want = jax_round_trip(
            lambda t: jp.wavedec(t, wavelet, mode=mode, level=level), lambda c: jp.waverec(c, wavelet, mode=mode), x
        )
        got = tp.wavedec(torch.from_numpy(x), wavelet, mode=mode, level=level)
        compare_leaves(got, want, REL_TOL, what, relative=True)
        rec = tp.waverec(got, wavelet, mode=mode)
        compare_leaves([rec], [rec_want], REL_TOL, what + " rec", relative=True)
        SEEN["fusion"].update(launched())

    run_draws(6, 99, draw)
    missed = {"K8a", "K8b"} - set(SEEN["fusion"])
    assert not missed, f"the draws launched {dict(SEEN['fusion'])}, not {sorted(missed)}"


@pytest.mark.parametrize(
    "taps,mode", [(130, mode) for mode in MODES] + [(129, "reflect"), (258, "periodization"), (258, "zero")]
)
def test_bank_past_the_tap_limit_matches_jax(fuzz_kernels, taps, mode):  # noqa: F811
    """A bank longer than the kernels take (``PTWT_MAX_TAPS`` = 128): K3/K4
    launch it in runs of at most 128 taps, summed, and K1/K2 decline it
    (the image is even and wide enough for K1 in ``periodic`` and
    ``periodization``); 1d and 2d levels, float64, against ``ptwt_tpu``,
    and the input's and the bank's gradients against the plain route.
    The forced-dispatch fuzz found K3 launched with 130 taps, which the
    card refuses."""
    bank = lattice_bank(taps, taps) if taps % 2 == 0 else tuple(
        np.random.RandomState(taps).randn(taps) / np.sqrt(taps) for _ in range(4)
    )
    rng = np.random.RandomState(taps + len(mode))
    level = 1 if taps % 2 else 2  # ptwt_tpu refuses an odd bank's longer chains
    for shape, fwd, inv in (
        ((1, 301), lambda p, t, b: p.wavedec(t, b, mode=mode, level=level),
         lambda p, c, b: p.waverec(c, b, mode=mode)),
        ((1, 136, 140), lambda p, t, b: p.wavedec2(t, b, mode=mode, level=1),
         lambda p, c, b: p.waverec2(c, b, mode=mode)),
    ):
        x = rng.randn(*shape)
        want, rec_want = jax_round_trip(lambda t: fwd(jp, t, bank), lambda c: inv(jp, c, bank), x)
        got = fwd(tp, torch.from_numpy(x), bank)
        compare_leaves(got, want, 1e-10, f"{shape} {mode}")
        compare_leaves([inv(tp, got, bank)], [rec_want], 1e-10, f"{shape} {mode} rec")
        counts = launched()
        assert set(counts) == {"K3", "K4"}, counts
        learn = tuple(torch.tensor(f, requires_grad=True) for f in bank)
        grads = []
        for route in (contextlib.nullcontext(), plain_route()):
            with route:
                inp = torch.from_numpy(x).requires_grad_()
                coeffs = fwd(tp, inp, learn)
                loss = _sum_squares(coeffs) + _sum_squares(inv(tp, coeffs, learn))
                grads.append(torch.autograd.grad(loss, [inp, *learn]))
        for i, (g, w) in enumerate(zip(*grads)):
            grad_close(g, w, 1e-10, f"{shape} {mode} gradient {i}")
        assert launched()["KT"]


@pytest.mark.parametrize(
    "wavelet,mode,n,level,long",
    [
        ("db5", "zero", 129, 4, "K8a K8b"),
        ("sym8", "reflect", 200, 4, "K8a K8b"),
        ("coif5", "periodic", 300, 4, "K8a K8b"),
        ("db20", "constant", 300, 3, "K8a K8b"),
        ("coif17", "symmetric", 129, 1, ""),
        ("coif17", "reflect", 300, 2, "K7a K8b"),
    ],
)
def test_lowered_floor_keeps_every_band(fuzz_kernels, monkeypatch, wavelet, mode, n, level, long):  # noqa: F811
    """With the long-lane floor lowered (as the forced-dispatch fuzz lowers
    it, and as the bench may set it), a long filter's run on a signal just
    past the floor outgrows its bands' edge strips: the K7/K8 gates take
    only the depths whose plan the kernel holds, and the values stay
    ``ptwt_tpu``'s (float64, 1e-10).  The gates had sent those runs to a
    plan that raised.  ``long``: the long-lane kernels launched (a
    shallower run, or one level on K7a, where the full depth does not
    hold; none where no depth holds, every level on K3/K4)."""
    monkeypatch.setattr(t8, "FLAT_MIN_LANES", FLOOR)
    x = np.random.RandomState(n + level).randn(2, n)
    want, rec_want = jax_round_trip(
        lambda t: jp.wavedec(t, wavelet, mode=mode, level=level), lambda c: jp.waverec(c, wavelet), x
    )
    got = tp.wavedec(torch.from_numpy(x), wavelet, mode=mode, level=level)
    compare_leaves(got, want, 1e-10, f"{wavelet} {mode} {n} L={level}")
    compare_leaves([tp.waverec(got, wavelet)], [rec_want], 1e-10, f"{wavelet} {mode} {n} L={level} rec")
    counts = launched()
    assert set(counts) - {"K3", "K4"} == set(long.split()), counts
