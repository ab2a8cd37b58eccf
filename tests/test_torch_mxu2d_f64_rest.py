"""``tests/test_torch_mxu2d.py``'s float64 check of K9's plain versions at
``(1, 256, 512)`` for the other banks, in a file of its own so that the test run
spreads the slow JAX references over its workers."""

from __future__ import annotations

import pytest
from test_torch_mxu2d import SHAPES, check_plain_float64, shape_ids
from _torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ['haar', 'db8', 'sym6', 'db20'])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=shape_ids([1]))
def test_mxu2_plain_float64_matches_jax(name, shape):
    check_plain_float64(name, shape)
