"""Helpers shared by the loops, the reference checks and the harness."""

from __future__ import annotations

import math

import torch

_MASK = (1 << 64) - 1

#: Streams of seeded data: a call's or step's input, and a loop's
#: initial parameters.
INPUT, PARAMS = 1, 2


def data_seed(seed: int, stream: int, index: int) -> int:
    """A 64-bit generator seed for item ``index`` of ``stream`` (splitmix64
    of the three), so every call's data follows from ``--seed`` alone."""
    z = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + index) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def normal(shape, device, seed: int, stream: int, index: int, dtype=torch.float32) -> torch.Tensor:
    """Standard normal data, made on ``device`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(data_seed(seed, stream, index))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def crop(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` cut to ``shape`` along its trailing axes (a padded-mode
    synthesis may return a sample more than the input had)."""
    index = (Ellipsis, *(slice(0, n) for n in shape))
    return t[index]


def detail_bands(coeffs, ndim: int) -> list:
    """Every detail band of a coefficient container, coarse to fine."""
    if ndim == 1:
        return list(coeffs[1:])
    return [band for triple in coeffs[1:] for band in triple]


def numel(shape) -> int:
    return math.prod(shape)
