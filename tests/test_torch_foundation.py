"""ptwt_tpu_torch foundation against ptwt_tpu: registry, padding, utils.

The same numpy inputs go through both packages on the CPU.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptwt_tpu.utils as jutils
import ptwt_tpu.wavelets as jwavelets
import ptwt_tpu_torch as ptwt_torch
import ptwt_tpu_torch.utils as tutils
import ptwt_tpu_torch.wavelets as twavelets
from ptwt_tpu_torch.constants import WaveletDetailTuple2d, WaveletTensorTuple
from _torch_one_thread import one_torch_thread  # noqa: F401

DATA = Path(__file__).parent / "data"
_TABLES = np.load(DATA / "filter_tables.npz")
MODES = ["zero", "constant", "reflect", "periodic", "symmetric", "periodization"]


def test_wavelist_matches():
    for kind in ("all", "discrete", "continuous"):
        assert twavelets.wavelist(kind=kind) == jwavelets.wavelist(kind=kind)
    assert len(twavelets.wavelist(kind="discrete")) == 106


@pytest.mark.parametrize("name", jwavelets.wavelist(kind="discrete"))
def test_filter_bank_bit_equal(name):
    got = [np.asarray(f) for f in twavelets.Wavelet(name).filter_bank]
    want = [np.asarray(f) for f in jwavelets.Wavelet(name).filter_bank]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    table = _TABLES["db1" if name == "haar" else name]
    np.testing.assert_array_equal(got[2], table)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape,axes,filt_len",
    [
        ((5,), (-1,), 8),  # db4 on length 5: pads longer than the signal
        ((2, 3), (-1,), 12),  # pads several times the length
        ((3, 7, 6), (-2, -1), 4),
        ((4, 9, 2), (0, -1), 6),
        ((1, 1), (-1,), 4),  # one sample
    ],
)
def test_fwt_pad_matches(mode, shape, axes, filt_len):
    x = np.random.RandomState(0).randn(*shape)
    want = np.asarray(jutils.fwt_pad(jnp.asarray(x), filt_len, mode=mode, axes=axes))
    got = tutils.fwt_pad(torch.from_numpy(x), filt_len, mode=mode, axes=axes)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["reflect", "symmetric", "zero"])
def test_fwt_pad_explicit_padding(mode):
    x = np.random.RandomState(1).randn(2, 6)
    pads = [(7, 2)]
    want = jutils.fwt_pad(jnp.asarray(x), 4, mode=mode, padding=pads)
    got = tutils.fwt_pad(torch.from_numpy(x), 4, mode=mode, padding=pads)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fwt_pad_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tutils.fwt_pad(torch.zeros(4), 2, mode="bogus")
    with pytest.raises(ValueError):
        tutils.translate_mode("bogus")
    assert tutils.translate_mode(None) == jutils.translate_mode(None)
    for mode in MODES[:-1]:
        assert tutils.translate_mode(mode) == jutils.translate_mode(mode)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 33, 1024])
@pytest.mark.parametrize("filt_len", [2, 4, 8, 18])
def test_get_pad_and_max_level_match(n, filt_len):
    assert tutils.get_pad(n, filt_len) == jutils.get_pad(n, filt_len)
    assert twavelets.dwt_max_level(n, filt_len) == jwavelets.dwt_max_level(n, filt_len)


@pytest.mark.parametrize(
    "lens,filt_len",
    [
        ([8, 16, 32], 8),
        ([9, 17, 33], 8),
        ([8, 16, 32], 2),
        ([16], 4),
        ([3, 5, 9], 4),
        ([130, 259, 515, 1024], 8),
    ],
)
def test_infer_periodization_matches(lens, filt_len):
    assert tutils.infer_periodization(lens, filt_len) == jutils.infer_periodization(
        lens, filt_len
    )


def test_subband_orders_match():
    assert tutils.SUBBAND_ORDERS == jutils._preprocess.SUBBAND_ORDERS


@pytest.mark.parametrize("flip", [True, False])
def test_get_filter_arrays_inputs(flip):
    want = jutils.get_filter_arrays("db3", flip=flip, dtype=jnp.float64)
    w = twavelets.Wavelet("db3")
    for source in ("db3", w, tuple(np.asarray(f) for f in w.filter_bank)):
        got = tutils.get_filter_arrays(source, flip=flip, dtype=torch.float64)
        for g, e in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, np.asarray(e))
    # tensors stay tensors, with their gradient path
    bank = WaveletTensorTuple.from_wavelet(w, dtype=torch.float64)
    learn = WaveletTensorTuple(*(f.clone().requires_grad_() for f in bank))
    got = tutils.get_filter_arrays(learn, flip=flip, dtype=torch.float64)
    assert all(isinstance(g, torch.Tensor) and g.requires_grad for g in got)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("axes", [(-2, -1), (0, 1), (1, 3)])
def test_preprocess_roundtrip(axes):
    x = np.random.RandomState(2).randn(2, 3, 4, 5)
    jd, jds = jutils.preprocess_tensor(jnp.asarray(x), 2, axes)
    td, tds = tutils.preprocess_tensor(torch.from_numpy(x), 2, axes)
    assert tds == tuple(jds)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    back = tutils.postprocess_tensor(td, 2, tds, axes)
    np.testing.assert_array_equal(back.numpy(), x)


def test_coeffs_numpy_roundtrip():
    rng = np.random.RandomState(3)
    tree = (rng.randn(2, 3, 3), (rng.randn(2, 3, 3),) * 3, (rng.randn(2, 6, 6),) * 3)
    coeffs = tutils.coeffs_from_numpy(tree, "cpu")
    assert isinstance(coeffs, tuple)
    assert all(isinstance(t, WaveletDetailTuple2d) for t in coeffs[1:])
    back = tutils.coeffs_to_numpy(coeffs)
    np.testing.assert_array_equal(back[0], tree[0])
    for got, want in zip(back[1:], tree[1:]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert isinstance(tutils.coeffs_from_numpy([tree[0], tree[0]], "cpu"), list)


def test_non_tensor_input_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device, numpy input is moved there")
    x = np.zeros((8, 8), dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptwt_torch.wavedec2(x, "haar")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptwt_torch.waverec2((x, (x, x, x)), "haar")


def test_unsupported_dtype_raises():
    with pytest.raises(ValueError, match="dtype"):
        ptwt_torch.wavedec2(torch.zeros(8, 8, dtype=torch.float16), "haar")


def test_public_names_match_jax():
    """The port exports the JAX package's whole public list, in its order."""
    import ptwt_tpu

    assert set(ptwt_torch.__all__) == set(ptwt_tpu.__all__)
    assert ptwt_torch.__all__ == ptwt_tpu.__all__
    for name in ptwt_torch.__all__:
        assert getattr(ptwt_torch, name) is not None


def test_parallel_names_match_jax():
    """``ptwt_tpu_torch.parallel`` exports ``ptwt_tpu.parallel``'s list, in
    its order."""
    import ptwt_tpu.parallel
    import ptwt_tpu_torch.parallel

    assert ptwt_tpu_torch.parallel.__all__ == ptwt_tpu.parallel.__all__
    for name in ptwt_tpu_torch.parallel.__all__:
        assert callable(getattr(ptwt_tpu_torch.parallel, name))


def test_parallel_transport_follows_the_backend(tmp_path, monkeypatch):
    """The ring's transport is read from the group's backend (never from a
    caught error), and a world of one rank makes no P2P or collective call
    and returns its input unchanged."""
    import datetime
    from types import SimpleNamespace

    import torch.distributed as dist

    from ptwt_tpu_torch.parallel import _ring, make_wavelet_mesh, tiled_wavedec2, tiled_waverec2

    for backend, device, staged in (("gloo", "cpu", False), ("gloo", "cuda", True), ("nccl", "cuda", False)):
        monkeypatch.setattr(dist, "get_backend", lambda group=None, b=backend: b)
        assert _ring._staged(None, SimpleNamespace(device=torch.device(device))) is staged
    for backend, device in (("nccl", "cpu"), ("mpi", "cpu"), ("gloo", "meta")):
        monkeypatch.setattr(dist, "get_backend", lambda group=None, b=backend: b)
        with pytest.raises(ValueError):
            _ring._staged(None, SimpleNamespace(device=torch.device(device)))
    monkeypatch.undo()

    timeout = datetime.timedelta(seconds=60)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            timeout=timeout)
    try:
        def refuse(*args, **kwargs):
            raise AssertionError("a ring of one rank made a call")

        for name in ("batch_isend_irecv", "all_reduce", "isend", "irecv"):
            monkeypatch.setattr(dist, name, refuse)
        # the ring's own transport: its ring step and its all-reduce
        for name in ("_all_to_all", "_all_reduce"):
            monkeypatch.setattr(_ring, name, refuse)
        mesh = make_wavelet_mesh(device_type="cpu", timeout=timeout)
        assert mesh.mesh_dim_names == ("data", "spatial") and tuple(mesh.shape) == (1, 1)
        t = torch.arange(6.0)
        assert _ring.ring_shift(t, "spatial", mesh, _ring.FWD) is t
        assert _ring.exchange([t, t[:2]], [_ring.FWD, _ring.BWD], "spatial", mesh)[1] is not None
        assert _ring.edge_sum(t, "spatial", mesh) is t
        x = torch.from_numpy(np.random.RandomState(5).randn(2, 32, 24))
        for mode in ("periodization", "reflect"):
            coeffs = tiled_wavedec2(x, "db3", level=2, mesh=mesh, mode=mode)
            want = ptwt_torch.wavedec2(x, "db3", mode=mode, level=2)
            for got, ref in zip(coeffs[1:], want[1:]):
                for g, r in zip(got, ref):
                    np.testing.assert_allclose(g.full_tensor().numpy(), r.numpy(), atol=1e-12)
            rec = tiled_waverec2(coeffs, "db3", mesh=mesh, mode=mode).full_tensor()
            np.testing.assert_allclose(rec.numpy(), ptwt_torch.waverec2(want, "db3", mode=mode).numpy(), atol=1e-12)
        with pytest.raises(ValueError, match="world size"):
            make_wavelet_mesh(2, 1, device_type="cpu", timeout=timeout)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_import_pulls_in_no_jax():
    """The port never imports JAX or ptwt_tpu (checked in a fresh process)."""
    src = Path(__file__).resolve().parent.parent / "src"
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import ptwt_tpu_torch, ptwt_tpu_torch.ops, ptwt_tpu_torch.utils,"
        " ptwt_tpu_torch.conv_transform, ptwt_tpu_torch.ops._pallas,"
        " ptwt_tpu_torch.ops._pallas1d, ptwt_tpu_torch.ops._pallas1d_multi,"
        " ptwt_tpu_torch.conv_transform_3, ptwt_tpu_torch.separable_conv_transform,"
        " ptwt_tpu_torch.stationary_transform, ptwt_tpu_torch.sparse_math,"
        " ptwt_tpu_torch.matmul_transform, ptwt_tpu_torch.matmul_transform_2,"
        " ptwt_tpu_torch.matmul_transform_3, ptwt_tpu_torch.ops._boundary,"
        " ptwt_tpu_torch.ops._boundary_long, ptwt_tpu_torch.ops._matmul, ptwt_tpu_torch.ops._conv,"
        " ptwt_tpu_torch.utils._deprecation,"
        " ptwt_tpu_torch.packets, ptwt_tpu_torch.continuous_transform,"
        " ptwt_tpu_torch.wavelets_learnable, ptwt_tpu_torch.parallel,"
        " ptwt_tpu_torch.parallel._ring, ptwt_tpu_torch.parallel._padded_axis,"
        " ptwt_tpu_torch.parallel.tiledn, ptwt_tpu_torch.parallel.tiled2d;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ptwt_tpu' or m.startswith('ptwt_tpu.')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(src)],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
