"""``torch.compile`` of ``ptwt_tpu_torch.parallel`` against ``jax.jit`` of
``ptwt_tpu``: the port's counterpart of ``jax.jit`` over ``shard_map``.

One gloo world of 4 worker processes (``tests/_torch_parallel_worker.py``,
suite ``compile``, no JAX) runs each case's round trip and the gradient of
the sum of its squared bands twice, eagerly and compiled with
``torch.compile(fullgraph=True, backend="aot_eager", dynamic=False)`` (the
forward, the inverse and the loss one graph, its backward compiled with
it), in float64: ``periodization`` on the meshes ``(1, 4)`` and ``(2, 2)``
(a ``DTensor`` input there), ``reflect`` on ``(1, 4)``, the chip grid
(``n_spatial_w=2``), the host axis (``n_hosts=2``), and the 1d and 3d
transforms in ``reflect``.  The tests hold ``torch._dynamo.explain``'s
count of graph breaks at 0, the compiled bands, reconstructions and
gradients against eager's at 1e-12, against ``jax.jit`` of the serial
``ptwt_tpu`` transform at 1e-12 (as ``tests/test_parallel.py`` holds the
JAX package's tiled transforms), the gradients against ``jax.jit`` of
``jax.grad`` at 1e-10, and one case against ``jax.jit`` of
``ptwt_tpu.parallel`` itself on 4 of the 8 virtual CPU devices.

Beside that world, two more (suite ``partial``: one rank on the mesh
``(1, 1)``, four on ``(1, 4)``) take losses of some of the returned
outputs, the approximation, one detail band or the reconstruction alone,
eager and compiled, each against ``jax.grad`` of the same loss over
``jax.jit`` of ``ptwt_tpu.parallel`` on that mesh shape (1e-10).  The
compiled function returns the outputs the loss does not take detached:
AOTAutograd (torch 2.13) cannot run a backward that leaves a returned
``DTensor`` needing grad without a cotangent (``README.md``).  That open
fault is pinned as it stands: the compiled forward returning its bands
needing grad, the loss of the approximation taken outside, raises.
"""

from __future__ import annotations

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_worker as worker
import ptwt_tpu as jptwt
from ptwt_tpu.parallel import make_wavelet_mesh, tiled_wavedec2, tiled_waverec2
from _torch_one_thread import one_torch_thread  # noqa: F401

SUITE = worker.SUITES["compile"]
CASES = list(SUITE)
#: Seconds the world gets: each rank traces every case twice (explain and
#: the compile), some 70 s on one core a rank.
WORLD_TIMEOUT = 300
ATOL = 1e-12
GRAD_ATOL = 1e-10
#: The case also held against jax.jit of ptwt_tpu.parallel.
AGAINST_JAX_TILED = "t2d-periodization-1x4"

_SERIAL = {
    "1d": (jptwt.wavedec, jptwt.waverec),
    "2d": (jptwt.wavedec2, jptwt.waverec2),
    "3d": (jptwt.wavedec3, jptwt.waverec3),
}


#: The partial-loss cases by world size.
PARTIAL = {1: "t2d-partial-1x1", 4: "t2d-partial-1x4"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Rank 0's results of the ``compile`` world and of both ``partial``
    worlds (by world size); the JAX references are computed while the
    ranks run."""
    with ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(worker.launch, "compile", 4, tmp_path_factory.mktemp("compile4"), WORLD_TIMEOUT)
        partial = {n: pool.submit(worker.launch, "partial", n, tmp_path_factory.mktemp(f"partial{n}"), WORLD_TIMEOUT)
                   for n in PARTIAL}
        for spec in SUITE.values():
            jitted(spec)
        jax_tiled()
        for name in PARTIAL.values():
            jax_partial(name)
        return ranks.result(), {n: f.result() for n, f in partial.items()}


@pytest.fixture(scope="module")
def world(worlds):
    return worlds[0]


def _results(world, name: str, tag: str) -> tuple[list, np.ndarray, np.ndarray]:
    """Bands, reconstruction and gradient of one run (``eager`` or
    ``compiled``) of a case."""
    arrays = world["arrays"]
    bands = [arrays[f"{name}/{tag}/band{i}"] for i in range(world[name]["bands"])]
    return bands, arrays[f"{name}/{tag}/rec"], arrays[f"{name}/{tag}/grad"]


def _squares(coeffs):
    return sum(jnp.sum(c**2) for c in jax.tree_util.tree_leaves(coeffs))


@functools.lru_cache(maxsize=None)
def _jitted(key: str):
    """``jax.jit`` of the serial transform, its round trip and ``jax.grad``
    of the sum of its squared coefficients, on the case's input."""
    spec = json.loads(key)
    fwd, inv = _SERIAL[spec["kind"]]
    kw = dict(mode=spec["mode"], level=spec["level"])
    x = jnp.asarray(worker.data(spec))
    coeffs = jax.jit(lambda z: fwd(z, spec["wavelet"], **kw))(x)
    rec = jax.jit(lambda z: inv(fwd(z, spec["wavelet"], **kw), spec["wavelet"], mode=spec["mode"]))(x)
    grad = jax.jit(jax.grad(lambda z: _squares(fwd(z, spec["wavelet"], **kw))))(x)
    return [np.asarray(c) for c in worker.leaves(coeffs)], np.asarray(rec), np.asarray(grad)


def jitted(spec):
    return _jitted(json.dumps({k: spec[k] for k in ("kind", "shape", "seed", "wavelet", "level", "mode")}))


@pytest.mark.parametrize("name", CASES)
def test_compiled_tiled_has_no_graph_break(world, name):
    """The round trip and the loss trace as one graph: the ring steps and
    edge sums are functional collectives, the banks and the geometry
    constants of the program."""
    meta = world[name]
    assert meta["graph_breaks"] == 0, meta["break_reasons"]
    assert meta["graphs"] == 1


@pytest.mark.parametrize("name", CASES)
def test_compiled_tiled_matches_eager(world, name):
    """Bands, reconstruction and gradient: compiled as eager."""
    got_bands, got_rec, got_grad = _results(world, name, "compiled")
    want_bands, want_rec, want_grad = _results(world, name, "eager")
    assert len(got_bands) == len(want_bands)
    for got, want in zip([*got_bands, got_rec, got_grad], [*want_bands, want_rec, want_grad]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_compiled_tiled_matches_jax_jit(world, name):
    """The compiled bands and reconstruction against ``jax.jit`` of the
    serial transform; ``periodization`` reconstructs its input."""
    spec = SUITE[name]
    got_bands, got_rec, _ = _results(world, name, "compiled")
    want_bands, want_rec, _ = jitted(spec)
    assert len(got_bands) == len(want_bands)
    for got, want in zip([*got_bands, got_rec], [*want_bands, want_rec]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if spec["mode"] == "periodization":
        np.testing.assert_allclose(got_rec, worker.data(spec), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_compiled_tiled_grad_matches_jax_grad(world, name):
    """The compiled loss's backward against ``jax.jit(jax.grad(...))``."""
    _, _, got = _results(world, name, "compiled")
    np.testing.assert_allclose(got, jitted(SUITE[name])[2], atol=GRAD_ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def jax_tiled():
    """``jax.jit`` of ``ptwt_tpu.parallel``'s round trip and ``jax.grad`` on
    :data:`AGAINST_JAX_TILED`'s mesh shape and input."""
    spec = SUITE[AGAINST_JAX_TILED]
    mesh = make_wavelet_mesh(n_data=spec["mesh"][0], n_spatial=spec["mesh"][1])
    kw = dict(level=spec["level"], mesh=mesh, mode=spec["mode"])
    x = jnp.asarray(worker.data(spec))
    coeffs = jax.jit(lambda z: tiled_wavedec2(z, spec["wavelet"], **kw))(x)
    rec = jax.jit(lambda c: tiled_waverec2(c, spec["wavelet"], mesh=mesh, mode=spec["mode"]))(coeffs)
    grad = jax.jit(jax.grad(lambda z: _squares(tiled_wavedec2(z, spec["wavelet"], **kw))))(x)
    return [np.asarray(c) for c in worker.leaves(coeffs)], np.asarray(rec), np.asarray(grad)


def test_compiled_tiled_matches_jax_tiled(world):
    """One case against ``jax.jit`` of ``ptwt_tpu.parallel`` on the same
    mesh shape: bands, reconstruction and ``jax.grad``."""
    spec = SUITE[AGAINST_JAX_TILED]
    assert spec["kind"] == "2d" and "mesh_kw" not in spec
    want_bands, want_rec, want_grad = jax_tiled()
    got_bands, got_rec, got_grad = _results(world, AGAINST_JAX_TILED, "compiled")
    assert len(got_bands) == len(want_bands)
    for got, want in zip([*got_bands, got_rec], [*want_bands, want_rec]):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_grad, want_grad, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_compiled_tiled_placements(world, name):
    """The compiled coefficients are ``DTensor``s of the eager layout: batch
    over ``data`` (``host`` then ``data``), the sharded axes over
    ``spatial`` (and ``spatial_w``)."""
    kw = SUITE[name].get("mesh_kw", {})
    want = ["S(0)", "S(1)"]
    if "n_hosts" in kw:
        want = ["S(0)", *want]
    if "n_spatial_w" in kw:
        want.append("S(2)")
    assert world[name]["placements"] == want


def test_ranks_import_no_jax(world):
    assert world["modules"] and not [m for m in world["modules"] if not m.startswith("ptwt_tpu_torch")]


@functools.lru_cache(maxsize=None)
def jax_partial(name: str) -> dict:
    """``jax.jit(jax.grad(...))`` of each partial loss (the sum of one
    output's squares) over ``ptwt_tpu.parallel``'s round trip, on the
    case's mesh shape of the virtual CPU devices."""
    spec = worker.SUITES["partial"][name]
    mesh = make_wavelet_mesh(n_data=spec["mesh"][0], n_spatial=spec["mesh"][1])
    kw = dict(mesh=mesh, mode=spec["mode"])

    def loss(part):
        def fn(z):
            coeffs = tiled_wavedec2(z, spec["wavelet"], level=spec["level"], **kw)
            rec = tiled_waverec2(coeffs, spec["wavelet"], **kw)
            return jnp.sum(worker._part(coeffs, rec, part) ** 2)

        return fn

    x = jnp.asarray(worker.data(spec))
    return {part: np.asarray(jax.jit(jax.grad(loss(part)))(x)) for part in worker.PARTS}


@pytest.mark.parametrize("part", worker.PARTS)
@pytest.mark.parametrize("ranks", list(PARTIAL))
def test_compiled_tiled_partial_loss_matches_jax_grad(worlds, ranks, part):
    """A loss of some of the outputs (the approximation, one detail band,
    the reconstruction) on one and on four ranks: compiled in one graph
    with no break, its gradient equal to eager's (1e-12) and to
    ``jax.grad`` over ``jax.jit`` of ``ptwt_tpu.parallel`` (1e-10)."""
    name = PARTIAL[ranks]
    result = worlds[1][ranks]
    assert result[name][part] == {"graph_breaks": 0, "graphs": 1}
    got, eager = (result["arrays"][f"{name}/{part}/{tag}/grad"] for tag in ("compiled", "eager"))
    np.testing.assert_allclose(got, eager, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, jax_partial(name)[part], atol=GRAD_ATOL, rtol=0)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("ranks", list(PARTIAL))
def test_compiled_tiled_bands_needing_grad_fault_stands(worlds, ranks):
    """The open fault, as it stands: ``tiled_wavedec2`` compiled
    (``fullgraph=True``, ``aot_eager``) returns its bands needing grad, and
    a backward from ``c[0].to_local().square().sum()`` taken outside the
    compiled function raises in AOTAutograd, which gets a plain tensor
    where a ``DTensor`` tangent belongs (torch 2.13).  When a torch release
    mends it this test fails: then clear the fault in ``ROADMAP.md`` and
    check this gradient against ``jax.grad`` as the partial losses do."""
    name = PARTIAL[ranks]
    error = worlds[1][ranks][name]["outside"]
    assert error is not None and "Expected a DTensor tangent but got a plain Tensor" in error, error
