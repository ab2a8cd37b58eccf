"""``ptwt_tpu_torch.parallel`` against ``ptwt_tpu`` on the CPU: the padded
modes, the 2d chip grid and the host axis (``tests/test_parallel_padded.py``'s
fast cases and the two padded modes they leave out) in a gloo world of 8
ranks, on the meshes ``(2, 4)``, ``(8, 1)``, ``(2, 2)`` with
``n_spatial_w=2`` and ``(1, 4)`` with ``n_hosts=2``.

Besides the serial transforms, one representative case is held against
``ptwt_tpu.parallel`` itself on the same mesh of 8 virtual devices: each
``shard_map`` compile costs seconds on one core (the 1d ``periodization``
ring's forward 1.6 s, a 2d one 3 s, a padded one 6-11 s), and the two
files together must stay within a minute on one core.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_worker as worker
from _torch_parallel_check import ATOL, bands, check_case, check_grad
from ptwt_tpu.parallel import make_wavelet_mesh, tiled_wavedec, tiled_wavedec2, tiled_wavedec3
from _torch_one_thread import one_torch_thread  # noqa: F401

SUITE = worker.SUITES["padded"]
CASES = list(SUITE)
#: Cases also held against ptwt_tpu.parallel on a (2, 4) mesh.
AGAINST_JAX_TILED = ("1d-periodization",)
_JAX_TILED = {"1d": tiled_wavedec, "2d": tiled_wavedec2, "3d": tiled_wavedec3}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.launch("padded", 8, tmp_path_factory.mktemp("world8"))


@pytest.mark.parametrize("name", CASES)
def test_tiled_padded_matches_serial(world, name):
    """Tiled bands and reconstruction equal the serial transform's."""
    check_case(world, name, SUITE[name])


@pytest.mark.parametrize("name", [n for n in CASES if SUITE[n].get("grad")])
def test_tiled_padded_gradients(world, name):
    check_grad(world, name, SUITE[name])


@pytest.mark.parametrize("name", AGAINST_JAX_TILED)
def test_matches_jax_tiled(world, name):
    spec = SUITE[name]
    assert spec["mesh"] == [2, 4] and "mesh_kw" not in spec
    x = jnp.asarray(worker.data(spec))
    coeffs = _JAX_TILED[spec["kind"]](x, spec["wavelet"], level=spec["level"], mesh=make_wavelet_mesh(2, 4),
                                      mode=spec["mode"])
    want = worker.leaves(coeffs)
    for got, w in zip(bands(world, name), want):
        np.testing.assert_allclose(got, np.asarray(w), atol=ATOL["float64"], rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_ring_of_one_makes_no_p2p(world, name):
    """The (8, 1) mesh's spatial axis holds one rank: no exchange."""
    spec = SUITE[name]
    assert (world[name]["p2p_batches"] == 0) == (spec["mesh"][1] == 1)


@pytest.mark.parametrize("name", CASES)
def test_placements(world, name):
    """Batch over ``data`` (``host`` then ``data``), the sharded image or
    volume axes over ``spatial`` (and ``spatial_w``)."""
    kw = SUITE[name].get("mesh_kw", {})
    want = ["S(0)", "S(1)"]
    if "n_hosts" in kw:
        want = ["S(0)", *want]
    if "n_spatial_w" in kw:
        want.append("S(2)")
    assert world[name]["placements"] == want


def test_ranks_import_no_jax(world):
    assert world["modules"] and not [m for m in world["modules"] if not m.startswith("ptwt_tpu_torch")]
