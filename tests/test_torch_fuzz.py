"""Randomized guards of ptwt_tpu_torch, part 1: the 1d surface.

The counterparts of ``tests/test_fuzz.py``'s 1d round trips, oracle
parity, packet recursion and matrix/swt sweeps, with the same seeds and
the same axes of variation (odd lengths, leading batch axes, deep levels,
biorthogonal and long filters, every mode), fewer draws each.  Every draw
runs ``ptwt_tpu`` and the port's kernel route (the CUDA glue on the numpy
kernel model, ``tests/_torch_fuzz.py``) on one seeded float64 input and
compares every coefficient leaf within 1e-10, then the reconstruction.

The 2d and 3d sweeps are in ``tests/test_torch_fuzz_2.py``, the forced
kernel dispatch and the fused multi-level runs in
``tests/test_torch_fuzz_kernels.py``.  ``test_fuzz_window_gemm`` has no
counterpart: the port has no windowed-GEMM route (its long levels run
exactly on K7/K8).
"""

from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_fuzz import compare_leaves, crop, fuzz_kernels, jax_round_trip, launched, run_draws  # noqa: F401

import ptwt_tpu as jp
import ptwt_tpu_torch as tp
from _torch_one_thread import one_torch_thread  # noqa: F401
from tests import _oracle

WAVELETS = ["haar", "db2", "db5", "sym4", "coif2", "bior2.4", "rbio3.3", "coif9"]
MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]
TOL = 1e-10

#: Kernels launched by each test's draws, and what its gates reach.
SEEN: dict = collections.defaultdict(collections.Counter)


def _tally(test: str) -> None:
    SEEN[test].update(launched())


def _reached(test: str, want: set) -> None:
    missed = want - set(SEEN[test])
    assert not missed, f"{test} launched {dict(SEEN[test])}, not {sorted(missed)}, which its gates reach"


def test_fuzz_1d_roundtrips(fuzz_kernels):  # noqa: F811
    def draw(rng, trial):
        n = int(rng.randint(8, 200))
        lead = tuple(rng.randint(1, 4, size=rng.randint(0, 3)))
        wavelet = WAVELETS[rng.randint(len(WAVELETS))]
        mode = MODES[rng.randint(len(MODES))]
        max_level = jp.dwt_max_level(n, jp.RegistryWavelet(wavelet).dec_len)
        if max_level < 1:
            return
        level = int(rng.randint(1, max_level + 1))
        x = rng.randn(*lead, n)
        what = f"{trial} {n} {lead} {wavelet} {mode} L={level}"
        want, rec_want = jax_round_trip(
            lambda t: jp.wavedec(t, wavelet, mode=mode, level=level),
            lambda c: jp.waverec(c, wavelet, mode=mode),
            x,
        )
        got = tp.wavedec(torch.from_numpy(x), wavelet, mode=mode, level=level)
        compare_leaves(got, want, TOL, what)
        rec = tp.waverec(got, wavelet, mode=mode)
        compare_leaves([rec], [rec_want], TOL, what + " rec")
        np.testing.assert_allclose(crop(rec.numpy(), x.shape), x, atol=TOL, rtol=0, err_msg=what)
        _tally("1d")

    run_draws(40, 123, draw)
    # periodization halving chains run the K6 pyramid, every other level K3/K4
    _reached("1d", {"K3", "K4", "K6a", "K6b"})


def test_fuzz_1d_oracle_parity(fuzz_kernels):  # noqa: F811
    """Value-level parity with the NumPy oracle and with ``ptwt_tpu`` at
    random configurations (biorthogonal, long filters up to dmey's 62
    taps, odd lengths, deep levels)."""
    wavs = ["haar", "db5", "db10", "sym7", "coif3", "bior2.4", "bior3.5", "rbio2.2", "coif8", "dmey"]
    modes = ["zero", "constant", "reflect", "periodic", "symmetric"]
    done = []

    def draw(rng, trial):
        wname = wavs[rng.randint(len(wavs))]
        mode = modes[rng.randint(len(modes))]
        n = int(rng.randint(16, 300))
        wav = jp.RegistryWavelet(wname)
        max_level = jp.dwt_max_level(n, wav.dec_len)
        if max_level < 1:
            return
        level = int(rng.randint(1, max_level + 1))
        x = rng.randn(2, n)
        what = f"{wname} {mode} n={n} L={level}"
        got = tp.wavedec(torch.from_numpy(x), wname, mode=mode, level=level)
        compare_leaves(got, _oracle.wavedec(x, wav, mode=mode, level=level), 1e-9, what + " oracle")
        want = jax.jit(lambda t: jp.wavedec(t, wname, mode=mode, level=level))(jnp.asarray(x))
        compare_leaves(got, want, TOL, what)
        _tally("oracle")
        done.append(trial)

    run_draws(24, 777, draw)
    assert len(done) > 12
    _reached("oracle", {"K3"})


def test_fuzz_packets_match_direct_recursion(fuzz_kernels):  # noqa: F811
    """Random packet-tree leaves equal the direct per-level recursion along
    their path, and ``ptwt_tpu``'s leaves."""

    def draw(rng, trial):
        w = ["haar", "db2", "db3", "sym4"][rng.randint(4)]
        mode = ["zero", "reflect", "symmetric", "periodic"][rng.randint(4)]
        n = int(rng.randint(32, 200))
        ml = int(rng.randint(1, 4))
        x = rng.randn(1, n)
        wp = tp.WaveletPacket(torch.from_numpy(x), w, mode=mode, maxlevel=ml)
        jwp = jp.WaveletPacket(jnp.asarray(x), w, mode=mode, maxlevel=ml)
        for _ in range(4):
            key = "".join("ad"[rng.randint(2)] for _ in range(int(rng.randint(1, ml + 1))))
            cur = torch.from_numpy(x)
            for ch in key:
                c = tp.wavedec(cur, w, mode=mode, level=1)
                cur = c[0] if ch == "a" else c[1]
            what = f"{trial} {w} {mode} n={n} path={key}"
            np.testing.assert_allclose(wp[key].numpy(), cur.numpy(), atol=TOL, rtol=0, err_msg=what)
            compare_leaves([wp[key]], [jwp[key]], TOL, what)
        _tally("packets")

    run_draws(8, 31337, draw)
    _reached("packets", {"K3"})


def test_fuzz_matrix_and_swt(fuzz_kernels):  # noqa: F811
    def draw(rng, trial):
        n = int(rng.randint(16, 128))
        wavelet = ["haar", "db2", "db3", "db4"][rng.randint(4)]
        x = rng.randn(2, n)
        what = f"{trial} n={n} {wavelet}"
        got = tp.MatrixWavedec(wavelet, level=None)(torch.from_numpy(x))
        want, rec_want = jax_round_trip(jp.MatrixWavedec(wavelet, level=None), jp.MatrixWaverec(wavelet), x)
        compare_leaves(got, want, 1e-9, what)
        out = tp.MatrixWaverec(wavelet)(got)
        compare_leaves([out], [rec_want], 1e-9, what + " rec")
        np.testing.assert_allclose(out.numpy()[..., :n], x, atol=1e-9, rtol=0, err_msg=what)
        n_pow2 = 1 << int(rng.randint(4, 8))
        xs = rng.randn(2, n_pow2)
        level = int(rng.randint(1, jp.swt_max_level(n_pow2) + 1))
        got = tp.swt(torch.from_numpy(xs), wavelet, level=level)
        want, rec_want = jax_round_trip(
            lambda t: jp.swt(t, wavelet, level=level), lambda c: jp.iswt(c, wavelet), xs
        )
        compare_leaves(got, want, TOL, what + f" swt {n_pow2} L={level}")
        rec = tp.iswt(got, wavelet)
        compare_leaves([rec], [rec_want], TOL, what + " iswt")
        np.testing.assert_allclose(rec.numpy(), xs, atol=TOL, rtol=0, err_msg=what)
        _tally("matrix")

    run_draws(10, 99, draw)
    # the dense operators and swt's convolutions launch no kernel
    _reached("matrix", set())
