"""Randomized guards of ptwt_tpu_torch, part 2: the 2d and 3d surface.

The counterparts of ``tests/test_fuzz.py``'s 2d round trips with
permuted axes and its 3d and fully separable sweep, with the same seeds
and axes of variation (odd shapes, non-trailing axes, deep levels,
biorthogonal and long filters, every mode), fewer draws each: every draw
runs ``ptwt_tpu`` and the port's kernel route (the CUDA glue on the numpy
kernel model, ``tests/_torch_fuzz.py``) on one seeded float64 input and
compares every coefficient leaf within 1e-10, then the reconstruction.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from _torch_fuzz import compare_leaves, crop, fuzz_kernels, jax_round_trip, launched, run_draws  # noqa: F401

import ptwt_tpu as jp
import ptwt_tpu_torch as tp
from _torch_one_thread import one_torch_thread  # noqa: F401

WAVELETS = ["haar", "db2", "db5", "sym4", "coif2", "bior2.4", "rbio3.3", "coif9"]
MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = 1e-10

#: Kernels launched by each test's draws.
SEEN: dict = collections.defaultdict(collections.Counter)


def _reached(test: str, want: set) -> None:
    missed = want - set(SEEN[test])
    assert not missed, f"{test} launched {dict(SEEN[test])}, not {sorted(missed)}, which its gates reach"


def test_fuzz_2d_roundtrips_with_axes(fuzz_kernels):  # noqa: F811
    def draw(rng, trial):
        h, w_ = int(rng.randint(12, 80)), int(rng.randint(12, 80))
        wavelet = WAVELETS[rng.randint(len(WAVELETS))]
        mode = MODES[rng.randint(len(MODES))]
        wav = jp.RegistryWavelet(wavelet)
        max_level = min(jp.dwt_max_level(s, wav.dec_len) for s in (h, w_))
        if max_level < 1:
            return
        level = int(rng.randint(1, max_level + 1))
        x = rng.randn(3, h, 2, w_)
        axes = (1, 3)
        what = f"{trial} {h}x{w_} {wavelet} {mode} L={level}"
        want, rec_want = jax_round_trip(
            lambda t: jp.wavedec2(t, wavelet, mode=mode, level=level, axes=axes),
            lambda c: jp.waverec2(c, wavelet, axes=axes, mode=mode),
            x,
        )
        got = tp.wavedec2(torch.from_numpy(x), wavelet, mode=mode, level=level, axes=axes)
        compare_leaves(got, want, TOL, what)
        rec = tp.waverec2(got, wavelet, axes=axes, mode=mode)
        compare_leaves([rec], [rec_want], TOL, what + " rec")
        np.testing.assert_allclose(crop(rec.numpy(), x.shape), x, atol=TOL, rtol=0, err_msg=what)
        SEEN["2d"].update(launched())

    run_draws(25, 321, draw)
    # K1/K2 on even periodic levels and periodization, K5b on a halving
    # periodization chain whose image was odd, K3/K4 elsewhere
    _reached("2d", {"K1", "K2", "K3", "K4", "K5b"})


def test_fuzz_3d_and_separable(fuzz_kernels):  # noqa: F811
    def draw(rng, trial):
        dims = tuple(int(rng.randint(10, 40)) for _ in range(3))
        wavelet = WAVELETS[rng.randint(4)]
        wav = jp.RegistryWavelet(wavelet)
        max_level = min(jp.dwt_max_level(s, wav.dec_len) for s in dims)
        if max_level < 1:
            return
        level = int(rng.randint(1, max_level + 1))
        x = rng.randn(2, *dims)
        what = f"{trial} {dims} {wavelet} L={level}"
        want, rec_want = jax_round_trip(
            lambda t: jp.wavedec3(t, wavelet, mode="reflect", level=level), lambda c: jp.waverec3(c, wavelet), x
        )
        got = tp.wavedec3(torch.from_numpy(x), wavelet, mode="reflect", level=level)
        compare_leaves(got, want, TOL, what)
        rec = tp.waverec3(got, wavelet)
        compare_leaves([rec], [rec_want], TOL, what + " rec")
        np.testing.assert_allclose(crop(rec.numpy(), x.shape), x, atol=TOL, rtol=0, err_msg=what)
        fs_want, frec_want = jax_round_trip(
            lambda t: jp.fswavedec3(t, wavelet, level=min(level, 2)), lambda c: jp.fswaverec3(c, wavelet), x
        )
        fs = tp.fswavedec3(torch.from_numpy(x), wavelet, level=min(level, 2))
        compare_leaves(fs, fs_want, TOL, what + " fs3")
        frec = tp.fswaverec3(fs, wavelet)
        compare_leaves([frec], [frec_want], TOL, what + " fs3 rec")
        np.testing.assert_allclose(crop(frec.numpy(), x.shape), x, atol=TOL, rtol=0, err_msg=what)
        SEEN["3d"].update(launched())

    run_draws(12, 7, draw)
    # one K3 launch per axis and level, K4 back
    _reached("3d", {"K3", "K4"})
