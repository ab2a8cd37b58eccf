"""The transforms of ``tests/test_jit.py``, written once for both packages.

Each row is one case of ``tests/test_jit.py`` (its wavelet, mode, level,
input shape, dtype and tolerance): ``make(p)`` builds, for a package
``p`` (``ptwt_tpu`` or ``ptwt_tpu_torch``), the row's forward transform
and its inverse (``None`` for ``cwt``).  The matrix rows build their
operator objects once per package, as the JAX test warms its stateful
cache before ``jax.jit``.  The inputs come from ``np.random.RandomState(7)``,
the seed of ``tests/test_jit.py``.
"""

from __future__ import annotations

import numpy as np

SEED = 7


def _conv(fwd, inv):
    def make(p):
        return (lambda t: fwd(p, t)), (lambda c: inv(p, c))

    return make


def _matrix(dec, rec, wavelet, level, shape):
    def make(p):
        mwd, mwr = getattr(p, dec)(wavelet, level=level), getattr(p, rec)(wavelet)
        return mwd, mwr

    return make


#: ``tests/test_jit.py``'s scales, 1 to 15, as python numbers: host values,
#: which a compiled ``cwt`` takes as constants of the program (an array of
#: scales is read to the host at a graph break, as ``jax.jit`` refuses a
#: traced one)
CWT_SCALES = tuple(range(1, 16))


def _cwt(p):
    return (lambda t: p.cwt(t, CWT_SCALES, "mexh")[0]), None


#: name -> (input shape, float64 input, make, tolerance of tests/test_jit.py)
ROWS = {
    "1d": ((3, 63), True, _conv(
        lambda p, t: p.wavedec(t, "db3", mode="symmetric", level=3), lambda p, c: p.waverec(c, "db3")), 1e-11),
    "2d": ((2, 37, 52), True, _conv(
        lambda p, t: p.wavedec2(t, "db2", mode="reflect", level=2), lambda p, c: p.waverec2(c, "db2")), 1e-11),
    "3d": ((1, 17, 20, 25), True, _conv(
        lambda p, t: p.wavedec3(t, "haar", mode="zero", level=2), lambda p, c: p.waverec3(c, "haar")), 1e-12),
    "fs2": ((2, 32, 48), True, _conv(
        lambda p, t: p.fswavedec2(t, "db2", level=2), lambda p, c: p.fswaverec2(c, "db2")), 1e-11),
    "swt": ((2, 64), True, _conv(lambda p, t: p.swt(t, "db2", level=3), lambda p, c: p.iswt(c, "db2")), 1e-11),
    "cwt": ((2, 128), False, _cwt, 1e-6),
    "mat": ((4, 64), True, _matrix("MatrixWavedec", "MatrixWaverec", "db2", 3, (4, 64)), 1e-11),
    "mat2": ((2, 32, 32), True, _matrix("MatrixWavedec2", "MatrixWaverec2", "haar", 2, (2, 32, 32)), 1e-12),
}


def row_input(name: str, batch: int = 0) -> np.ndarray:
    """The row's input (``[batch, *shape]`` stacked copies of distinct
    draws where ``batch`` is given)."""
    shape, f64, _, _ = ROWS[name]
    x = np.random.RandomState(SEED).randn(*((batch,) if batch else ()), *shape)
    return x if f64 else x.astype(np.float32)


def roundtrip(fwd, inv):
    """The row's function of ``tests/test_jit.py``: the round trip, or the
    forward transform alone where there is no inverse."""
    if inv is None:
        return fwd
    return lambda t: inv(fwd(t))
