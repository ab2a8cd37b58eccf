"""``ptwt_tpu_torch.parallel`` against ``ptwt_tpu`` on the CPU: the cases of
``tests/test_parallel.py`` in a gloo world of 4 ranks.

One world of worker processes (``tests/_torch_parallel_worker.py``, no
JAX) computes every case in float64 (one in float32) on the meshes
``(1, 4)``, ``(2, 2)`` and ``(4, 1)``; the tests hold its bands,
reconstructions and gradients against ``ptwt_tpu``'s serial transforms and
``jax.grad`` within the JAX tests' limits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from _torch_parallel_check import GRAD_ATOL, check_case, check_grad, check_grad2, bands
from ptwt_tpu_torch.parallel._padded_axis import sharded_idwt_level
from _torch_one_thread import one_torch_thread  # noqa: F401

SUITE = worker.SUITES["parallel"]
CASES = [name for name, spec in SUITE.items() if not spec.get("error")]
ERRORS = {
    "err-divisible": "divisible",
    "err-halo": "Halo",
    "err-halo-1d": "halo",
    "err-neighbour": "beyond one neighbour",
    "err-world": "world size",
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.launch("parallel", 4, tmp_path_factory.mktemp("world4"))


@pytest.mark.parametrize("name", CASES)
def test_tiled_matches_serial(world, name):
    """Tiled bands and reconstruction equal the serial transform's."""
    check_case(world, name, SUITE[name])


@pytest.mark.parametrize("name", [n for n in CASES if SUITE[n].get("grad") and n != "2d-grad"])
def test_tiled_grad_matches_jax_grad(world, name):
    check_grad(world, name, SUITE[name])


@pytest.mark.parametrize("name", [n for n in CASES if SUITE[n].get("grad2")])
def test_tiled_grad_of_grad_matches_jax(world, name):
    """A second derivative through the tiled transform: the first backward
    (``create_graph=True``) runs the ring steps back and the edge sums'
    all-reduce as differentiable Functions, so the second sums the terms
    that ``jax.grad`` of ``jax.grad`` over ``ppermute``/``psum`` does."""
    check_grad2(world, name, SUITE[name])


def test_tiled_grad_flows(world):
    """Gradients flow through the halo exchanges: periodization is
    orthonormal for db2, so d/dx sum c^2 = 2x (``jax.grad``'s value too)."""
    x = worker.data(SUITE["2d-grad"])
    np.testing.assert_allclose(world["arrays"]["2d-grad/grad"], 2 * x, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("name", [n for n in CASES if SUITE[n].get("schedules")])
def test_overlap_schedules_agree(world, name):
    """Overlapped and pad-then-compute ring schedules: equal bands and
    reconstructions bit for bit, gradients to rounding."""
    arrays = world["arrays"]
    for a, b in zip(bands(world, name), bands(world, f"{name}/no-overlap")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(arrays[f"{name}/rec"], arrays[f"{name}/no-overlap/rec"])
    np.testing.assert_allclose(arrays[f"{name}/grad"], arrays[f"{name}/no-overlap/grad"], atol=1e-12, rtol=0)
    # the overlapped schedule posts one exchange per ring level, the other
    # one per halo pad and one per synthesis fold
    assert 0 < world[name]["p2p_batches"] < world[f"{name}/no-overlap"]["p2p_batches"]


@pytest.mark.parametrize("name", CASES)
def test_ring_of_one_makes_no_p2p(world, name):
    """A spatial axis of one rank (or a halo of 0, haar) exchanges nothing."""
    spec = SUITE[name]
    one = spec["mesh"][1] == 1 or spec["wavelet"] == "haar"
    assert (world[name]["p2p_batches"] == 0) == one


def test_coefficients_are_sharded_dtensors(world):
    """Batch over ``data``, the first transformed axis over ``spatial``."""
    for name in CASES:
        assert world[name]["placements"] == ["S(0)", "S(1)"]


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_tiled_validation_errors(world, name):
    assert ERRORS[name] in world[name]["error"]


def test_synthesis_overlap_error():
    """A synthesis level whose overlap exceeds one chunk raises before it
    exchanges anything."""
    geo = dict(p=8, cap_out=3, s=4)
    band = torch.zeros(1, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="synthesis overlap"):
        sharded_idwt_level([band], [band], geo, np.ones(10), np.ones(10), 8, -1, "spatial", None)


def test_ranks_import_no_jax(world):
    assert world["modules"] and not [m for m in world["modules"] if not m.startswith("ptwt_tpu_torch")]
