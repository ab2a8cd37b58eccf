"""Shared pieces of the port's randomized guards, ``tests/test_torch_fuzz*.py``.

The counterparts of ``tests/test_fuzz.py`` draw their configurations with
the same seeds and the same axes of variation, send each draw through
``ptwt_tpu`` (JAX on the CPU, x64) and through ``ptwt_tpu_torch`` on its
kernel route (CPU tensors down the CUDA glue, the numpy model of
``tests/test_torch_kernels.py`` standing in for the kernels), and compare
every coefficient leaf.

:func:`fuzz_kernels` is that route, stricter than ``model_kernels`` at the
C boundary: each launch must meet the argument rules the entry points
check (``sizes_ok`` of ``csrc/common.cuh``: 1 to ``PTWT_MAX_TAPS`` taps,
2 for the pyramid kernels; contiguous tensors of the launch's dtype), and
every launch is tallied in :data:`SEEN` of the test module, so that each
file can assert which kernels its draws reached.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import _model_launch

from ptwt_tpu_torch.ops import _kernels
from ptwt_tpu_torch.ops import _pallas as t6
from ptwt_tpu_torch.ops import _pallas1d as t7
from ptwt_tpu_torch.ops import _pallas1d_multi as t8
from ptwt_tpu_torch.ops import _pallas2 as t2
from ptwt_tpu_torch.ops import _pallas2d as t2d

#: ``PTWT_MAX_TAPS`` of ``csrc/common.cuh``.
MAX_TAPS = 128

#: Per C entry point: the position of its ``n_taps`` argument (after the
#: dtype code) and the fewest taps it takes.
_TAPS_ARG = {
    "ptwt_analysis_axis": (4, 1),
    "ptwt_synthesis_axis": (8, 1),
    "ptwt_tap_grad": (9, 1),
    "ptwt_dwt2": (4, 1),
    "ptwt_idwt2": (7, 1),
    "ptwt_mxu2d_analysis": (4, 1),
    "ptwt_mxu2d_synthesis": (7, 1),
    "ptwt_fwt1d_analysis": (8, 2),
    "ptwt_fwt1d_synthesis": (8, 2),
    "ptwt_pyramid2d_analysis": (5, 2),
    "ptwt_pyramid2d_synthesis": (5, 2),
}

def _strict_launch(kernel, entry, device, dtype, *args):
    index, least = _TAPS_ARG[entry]
    taps = args[index]
    assert least <= taps <= MAX_TAPS, f"{kernel} ({entry}) launched with {taps} taps"
    for a in args:
        if isinstance(a, torch.Tensor):
            # KT sums its taps' gradient in float64
            dtypes = (dtype, torch.float64) if entry == "ptwt_tap_grad" else (dtype,)
            assert a.dtype in dtypes and a.is_contiguous(), f"{kernel} ({entry}): {a.dtype}, {a.stride()}"
            assert a.numel() > 0, f"{kernel} ({entry}) launched on an empty tensor"
    _model_launch(kernel, entry, device, dtype, *args)


def _check_tensor(name, t, dtype, device):
    assert t.dtype == dtype and t.is_contiguous(), f"{name}: {t.dtype}, {t.stride()}"


def install(monkeypatch) -> None:
    """Send CPU tensors down the CUDA glue onto the strict kernel model."""
    monkeypatch.setattr(_kernels, "launch", _strict_launch)
    monkeypatch.setattr(_kernels, "check_tensor", _check_tensor)
    for module in (t2, t2d, t6, t7, t8):
        monkeypatch.setattr(module, "_on_cpu", lambda t: False)
    _kernels.reset_launch_counts()


def launched() -> dict:
    """The launch counts since :func:`install` or the last call, then reset."""
    counts = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    _kernels.reset_launch_counts()
    return counts


def leaves(tree) -> list:
    """The arrays of a coefficient tree, in order (lists, tuples, dicts)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in leaves(item)]
    return [tree]


def as_numpy(a) -> np.ndarray:
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def compare_leaves(got, want, tol: float, what: str, relative: bool = False) -> float:
    """Every leaf of ``got`` (the port) against ``want`` (``ptwt_tpu``):
    same count, shapes and dtypes, max-abs difference within ``tol`` (over
    ``max(1, |leaf|)`` where ``relative``).  Returns the worst error."""
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want), f"{what}: {len(got)} leaves against {len(want)}"
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = as_numpy(g), as_numpy(w)
        assert g.shape == w.shape, f"{what}: leaf {i} {g.shape} against {w.shape}"
        assert g.dtype == w.dtype, f"{what}: leaf {i} {g.dtype} against {w.dtype}"
        if not g.size:
            continue
        assert np.isfinite(g).all(), f"{what}: leaf {i} not finite"
        err = float(np.abs(g.astype(np.float64) - w).max())
        if relative:
            err /= max(1.0, float(np.abs(w).max()))
        assert err <= tol, f"{what}: leaf {i} differs by {err!r} (limit {tol!r})"
        worst = max(worst, err)
    return worst


def jax_round_trip(forward, inverse, x):
    """``ptwt_tpu``'s coefficients of ``x`` and their reconstruction, as one
    program: one compile a draw, where the eager transforms compile every
    primitive at every new shape."""

    def both(t):
        coeffs = forward(t)
        return coeffs, inverse(coeffs)

    return jax.jit(both)(jnp.asarray(x))


def crop(rec: np.ndarray, shape) -> np.ndarray:
    return rec[tuple(slice(0, s) for s in shape)]


def run_draws(count: int, seed: int, draw: Callable[[np.random.RandomState, int], None]) -> None:
    rng = np.random.RandomState(seed)
    for trial in range(count):
        draw(rng, trial)


@pytest.fixture
def fuzz_kernels(monkeypatch):
    install(monkeypatch)
    yield _kernels.LAUNCHES
    _kernels.reset_launch_counts()


_WRAPPERS = (t2, t2d, t6, t7, t8)


class plain_route:
    """Inside: the kernel wrappers take their plain versions, as on any CPU
    tensor; on leaving, the kernel route of :func:`install` again."""

    def __enter__(self):
        self._saved = [module._on_cpu for module in _WRAPPERS]
        for module in _WRAPPERS:
            module._on_cpu = lambda t: True

    def __exit__(self, *exc):
        for module, fn in zip(_WRAPPERS, self._saved):
            module._on_cpu = fn


def grad_close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> float:
    """A gradient against its reference, within ``tol`` of the reference's
    largest entry."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.double() - want.double()).abs().max()) / scale
    assert err <= tol, f"{what}: gradient differs by {err!r} of its largest entry (limit {tol!r})"
    return err
