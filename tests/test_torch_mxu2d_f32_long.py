"""``tests/test_torch_mxu2d.py``'s float32 check of K9's plain versions at
``(1, 256, 512)`` for the two longest banks, in a file of its own so that the test run
spreads the slow JAX references over its workers."""

from __future__ import annotations

import pytest
from test_torch_mxu2d import SHAPES, check_plain, shape_ids
from _torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ['db20', 'sym6'])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=shape_ids([1]))
def test_mxu2_plain_matches_jax(name, shape):
    check_plain(name, shape)
