"""A user's filter bank longer than the kernels' tap limit, for the tests.

``tests/test_torch_cuda.py`` imports it too, so it imports neither JAX nor
``ptwt_tpu`` (``chip_smoke.py`` keeps its own copy, ``lattice_bank``).
"""

from __future__ import annotations

import numpy as np


def lattice_bank(taps: int, seed: int) -> tuple:
    """A user's orthogonal bank of ``taps`` (even) taps, ``(dec_lo, dec_hi,
    rec_lo, rec_hi)`` as numpy: the paraunitary lattice of ``taps / 2``
    random rotations with delays between them, ``sum(rec_lo) = sqrt(2)``,
    so that the round trip is exact in every mode."""
    rs = np.random.RandomState(seed)
    angles = rs.uniform(-np.pi, np.pi, taps // 2)
    angles[-1] = np.pi / 4 - angles[:-1].sum()
    # the polyphase matrix E(z) = R_K D(z) ... D(z) R_0 as polynomials in
    # 1/z, D(z) = diag(1, 1/z) delaying its second row; rec_lo's even and
    # odd taps are E's first row
    c0, s0 = np.cos(angles[0]), np.sin(angles[0])
    rows = [[np.array([c0]), np.array([s0])], [np.array([-s0]), np.array([c0])]]
    for theta in angles[1:]:
        c, s = np.cos(theta), np.sin(theta)
        top = [np.append(p, 0.0) for p in rows[0]]
        low = [np.insert(p, 0, 0.0) for p in rows[1]]
        rows = [[c * a + s * b for a, b in zip(top, low)], [c * b - s * a for a, b in zip(top, low)]]
    rec_lo = np.empty(taps)
    rec_lo[0::2], rec_lo[1::2] = rows[0]
    rec_hi = np.array([(-1) ** k * rec_lo[taps - 1 - k] for k in range(taps)])
    return rec_lo[::-1].copy(), rec_hi[::-1].copy(), rec_lo, rec_hi
