"""One torch intra-op thread for a test module's tests.

The test run puts several workers on the machine's cores at once; each
worker's torch would otherwise start an OpenMP team as wide as the
machine for every CPU op, and the teams' spinning barriers then take
turns on oversubscribed cores (six workers on eight cores slowed the K9
CPU tests by two orders of magnitude).  A module imports the fixture to
use it; the thread count is restored when the module's tests are done.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
