"""The JAX side of the ``ptwt_tpu_torch.parallel`` tests: references from
``ptwt_tpu`` for the cases of ``_torch_parallel_worker.SUITES``, and the
checks the two test modules share."""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np

import _torch_parallel_worker as worker
import ptwt_tpu as jptwt

#: The JAX tests' own limit (float64); float32 cases against float64.
ATOL = {"float64": 1e-12, "float32": 1e-5}
GRAD_ATOL = 1e-10

_SERIAL = {
    "1d": (jptwt.wavedec, jptwt.waverec),
    "2d": (jptwt.wavedec2, jptwt.waverec2),
    "3d": (jptwt.wavedec3, jptwt.waverec3),
}


def _key(spec) -> str:
    return json.dumps({k: spec[k] for k in ("kind", "shape", "seed", "wavelet", "level", "mode", "dtype") if k in spec})


@functools.lru_cache(maxsize=None)
def _serial(key: str):
    spec = json.loads(key)
    x = jnp.asarray(worker.data(spec).astype(np.float64))
    fwd, inv = _SERIAL[spec["kind"]]
    coeffs = fwd(x, spec["wavelet"], mode=spec["mode"], level=spec["level"])
    rec = inv(coeffs, spec["wavelet"], mode=spec["mode"])
    return [np.asarray(c) for c in worker.leaves(coeffs)], np.asarray(rec)


def serial(spec):
    """``ptwt_tpu``'s serial bands (in ``worker.leaves`` order) and
    reconstruction of the case's input, in float64."""
    return _serial(_key(spec))


def serial_grad(spec) -> np.ndarray:
    """``jax.grad`` of the sum of the squared serial coefficients."""
    fwd, _ = _SERIAL[spec["kind"]]

    def loss(z):
        coeffs = fwd(z, spec["wavelet"], mode=spec["mode"], level=spec["level"])
        return sum(jnp.sum(c**2) for c in jax.tree_util.tree_leaves(coeffs))

    return np.asarray(jax.grad(loss)(jnp.asarray(worker.data(spec))))


def serial_grad2(spec) -> np.ndarray:
    """``jax.grad`` of the squared ``jax.grad`` of the sum of the cubed
    serial coefficients."""
    fwd, _ = _SERIAL[spec["kind"]]

    def loss(z):
        coeffs = fwd(z, spec["wavelet"], mode=spec["mode"], level=spec["level"])
        return sum(jnp.sum(c**3) for c in jax.tree_util.tree_leaves(coeffs))

    return np.asarray(jax.grad(lambda z: jnp.sum(jax.grad(loss)(z) ** 2))(jnp.asarray(worker.data(spec))))


def bands(results: dict, name: str) -> list:
    meta = results[name]
    return [results["arrays"][f"{name}/band{i}"] for i in range(meta["bands"])]


def check_case(results: dict, name: str, spec) -> None:
    """The port's tiled bands and reconstruction against ``ptwt_tpu``'s
    serial transform: equal shapes, values within the JAX tests' limit."""
    atol = ATOL[spec.get("dtype", "float64")]
    want, want_rec = serial(spec)
    got = bands(results, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    rec = results["arrays"][f"{name}/rec"]
    assert rec.shape == want_rec.shape
    np.testing.assert_allclose(rec, want_rec, atol=atol, rtol=0)
    if spec["mode"] == "periodization":
        np.testing.assert_allclose(rec, worker.data(spec), atol=atol, rtol=0)


def check_grad(results: dict, name: str, spec) -> None:
    got = results["arrays"][f"{name}/grad"]
    np.testing.assert_allclose(got, serial_grad(spec), atol=GRAD_ATOL, rtol=0)


def check_grad2(results: dict, name: str, spec) -> None:
    got = results["arrays"][f"{name}/grad2"]
    np.testing.assert_allclose(got, serial_grad2(spec), atol=GRAD_ATOL, rtol=0)
