"""One rank of a gloo world that runs ``ptwt_tpu_torch.parallel`` on the CPU.

``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_padded.py``
and ``tests/test_torch_parallel_compile.py`` start one world per module
(:func:`launch`): ``world`` processes of ``python
tests/_torch_parallel_worker.py --rank R --world W --store FILE --suite
NAME --out DIR``, which meet through a ``file://`` store, compute every
case of :data:`SUITES` ``[NAME]`` in float64 (one in float32; the
``compile`` suite eager and under ``torch.compile``), and leave rank 0's
results in ``DIR/results.npz`` and ``DIR/results.json``.
This module imports only ``torch`` and ``ptwt_tpu_torch``: a rank holds no
JAX (each asserts it), and the parents compare the results with
``ptwt_tpu``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

#: Seconds a rank waits for its peers in any one operation.
PG_TIMEOUT = 60
#: Seconds the parent gives a whole world.
WORLD_TIMEOUT = 240

#: The analysis and synthesis entry points of each kind of case.
FUNCS = {"1d": ("tiled_wavedec", "tiled_waverec"), "2d": ("tiled_wavedec2", "tiled_waverec2"),
         "3d": ("tiled_wavedec3", "tiled_waverec3")}


def case(kind, mesh, shape, wavelet, level, mode="periodization", seed=0, **extra):
    """One transform of seeded ``randn(*shape)`` on a mesh ``(n_data,
    n_spatial)`` (``extra["mesh_kw"]``: ``n_hosts``, ``n_spatial_w``).

    Extras: ``dtype`` ("float64"), ``grad`` (the gradient of the sum of the
    squared coefficients), ``grad2`` (the gradient of the squared gradient
    of the sum of the cubed coefficients: a second backward through the
    ring steps and edge sums), ``schedules`` (both ring schedules), ``data_in``
    ("whole", "shard" or "replicate": the input as the whole tensor or a
    ``DTensor``), ``coeffs_in`` ("dtensor" or "whole": what goes into the
    inverse), ``error`` (the call must raise ``ValueError``)."""
    return dict(kind=kind, mesh=list(mesh), shape=list(shape), wavelet=wavelet, level=level, mode=mode,
                seed=seed, **extra)


def _matches_serial():
    return {
        f"2d-{wav}-{m[0]}x{m[1]}": case("2d", m, (8, 128, 64), wav, 3, seed=2,
                                        data_in="shard" if m == (2, 2) else "whole")
        for wav in ("haar", "db4", "sym3")
        for m in ((1, 4), (2, 2), (4, 1))
    }


SUITES = {
    # tests/test_parallel.py's cases on a world of 4 ranks
    "parallel": {
        **_matches_serial(),
        "2d-grad": case("2d", (1, 4), (2, 64, 32), "db2", 2, seed=3, grad=True),
        "1d-haar": case("1d", (2, 2), (4, 256), "haar", 3, seed=3),
        "1d-db3": case("1d", (2, 2), (4, 256), "db3", 3, seed=3, data_in="replicate"),
        "3d": case("3d", (2, 2), (2, 32, 16, 24), "db2", 2, seed=4, coeffs_in="whole"),
        "overlap": case("2d", (2, 2), (4, 128, 64), "db3", 2, seed=11, schedules=True, grad=True),
        "overlap-1d": case("1d", (1, 4), (2, 256), "db4", 3, seed=12, schedules=True, grad=True),
        "f32": case("2d", (1, 4), (4, 64, 72), "db3", 2, "reflect", seed=13, dtype="float32"),
        "2d-grad2-reflect": case("2d", (1, 4), (2, 64, 32), "db2", 2, "reflect", seed=14, grad2=True),
        "err-divisible": case("2d", (1, 4), (2, 100, 64), "db4", 2, error=True),
        "err-halo": case("2d", (1, 4), (2, 64, 64), "db8", 3, error=True),
        "err-halo-1d": case("1d", (1, 4), (2, 64), "db4", 4, error=True),
        "err-neighbour": case("1d", (1, 4), (2, 16), "db5", 1, "reflect", error=True),
        "err-world": case("2d", (2, 4), (2, 64, 64), "db2", 1, error=True),
    },
    # tests/test_parallel_padded.py's fast cases (and the other padded
    # modes) on a world of 8 ranks
    "padded": {
        **{
            f"1d-{mode}-{n}-{wav}": case("1d", (2, 4), (4, n), wav, lvl, mode, seed=0)
            for mode, n, wav, lvl in (
                ("reflect", 256, "db3", 3), ("periodic", 264, "db2", 2), ("constant", 264, "db2", 2),
                ("zero", 264, "db2", 2), ("symmetric", 512, "db5", 3),
            )
        },
        "1d-periodization": case("1d", (2, 4), (4, 256), "db3", 3, seed=3),
        "2d-periodic": case("2d", (2, 4), (4, 64, 72), "db3", 2, "periodic", seed=1, data_in="shard"),
        "2d-periodization": case("2d", (2, 4), (8, 128, 64), "sym3", 3, seed=2),
        "2d-8x1": case("2d", (8, 1), (8, 128, 64), "db4", 3, seed=2),
        "2d-8x1-reflect": case("2d", (8, 1), (8, 64, 72), "db3", 2, "reflect", seed=1),
        "grid-periodization": case("2d", (2, 2), (4, 64, 64), "db3", 2, seed=2, mesh_kw={"n_spatial_w": 2},
                                   grad=True),
        "host-reflect": case("2d", (1, 4), (2, 64, 32), "db2", 2, "reflect", seed=3, mesh_kw={"n_hosts": 2}),
        "grid-reflect": case("2d", (2, 2), (4, 72, 68), "db2", 2, "reflect", seed=6, mesh_kw={"n_spatial_w": 2},
                             grad=True),
        "1d-grad": case("1d", (2, 4), (2, 256), "db3", 2, "reflect", seed=4, grad=True),
        "3d-periodization": case("3d", (2, 4), (2, 32, 16, 24), "db2", 2, seed=4),
        "3d-reflect": case("3d", (2, 4), (2, 32, 20, 24), "db2", 2, "reflect", seed=5, grad=True),
        "3d-grid-periodic": case("3d", (2, 2), (2, 24, 20, 16), "db2", 2, "periodic", seed=7,
                                 mesh_kw={"n_spatial_w": 2}),
    },
    # the round trip and the gradient of the sum of the squared bands under
    # torch.compile(fullgraph=True), eager beside it, on a world of 4 ranks
    "compile": {
        "t2d-periodization-1x4": case("2d", (1, 4), (2, 64, 32), "db4", 2, seed=20),
        "t2d-periodization-2x2": case("2d", (2, 2), (4, 32, 16), "db4", 1, seed=21, data_in="shard"),
        "t2d-reflect-1x4": case("2d", (1, 4), (2, 64, 36), "db2", 2, "reflect", seed=22),
        "grid-periodization": case("2d", (1, 2), (2, 32, 32), "db3", 1, seed=23, mesh_kw={"n_spatial_w": 2}),
        "host-reflect": case("2d", (1, 2), (2, 40, 32), "db2", 1, "reflect", seed=24, mesh_kw={"n_hosts": 2}),
        "td1-reflect-1x4": case("1d", (1, 4), (2, 256), "db3", 2, "reflect", seed=25),
        "td3-reflect-2x2": case("3d", (2, 2), (2, 24, 12, 10), "db2", 1, "reflect", seed=26),
    },
    # a loss of some of the returned bands (the approximation, one detail
    # band, the reconstruction) under torch.compile(fullgraph=True): one
    # case for a world of 1 rank, one for a world of 4
    "partial": {
        "t2d-partial-1x1": case("2d", (1, 1), (2, 32, 32), "db2", 2, seed=27),
        "t2d-partial-1x4": case("2d", (1, 4), (2, 32, 32), "db2", 2, seed=27),
    },
}

#: The partial losses: which of a 2d case's outputs each one squares.
PARTS = ("approx", "detail", "rec")


def data(spec) -> np.ndarray:
    """The case's input, as the parent makes it too."""
    x = np.random.RandomState(spec["seed"]).randn(*spec["shape"])
    return x.astype(spec.get("dtype", "float64"))


def leaves(coeffs) -> list:
    """A coefficient container's bands in order: the approximation, then
    each level's detail tuple in its order or detail dict by key."""
    out = []
    for entry in coeffs:
        if isinstance(entry, dict):
            out.extend(entry[k] for k in sorted(entry))
        elif isinstance(entry, (tuple, list)):
            out.extend(entry)
        else:
            out.append(entry)
    return out


def launch(suite: str, world: int, out: Path, timeout: float = WORLD_TIMEOUT) -> dict:
    """Run one world of ``suite`` and return rank 0's results (arrays and
    metadata); raises with the ranks' output if any rank fails or the
    world outlasts ``timeout`` seconds."""
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    cmd = [sys.executable, __file__, "--world", str(world), "--store", str(store), "--suite", suite,
           "--out", str(out)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PTWT_TPU_NO_OVERLAP", None)
    procs = [
        subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    meta = json.loads((out / "results.json").read_text())
    with np.load(out / "results.npz") as arrays:
        meta["arrays"] = dict(arrays)
    return meta


# ---------------------------------------------------------------------------
# the rank
# ---------------------------------------------------------------------------


def _run_case(name, spec, mesh, torch, dist, par, arrays, meta):
    from torch.distributed.tensor import Replicate, distribute_tensor

    fwd = getattr(par, FUNCS[spec["kind"]][0])
    inv = getattr(par, FUNCS[spec["kind"]][1])
    x = torch.from_numpy(data(spec))
    kw = dict(level=spec["level"], mesh=mesh, mode=spec["mode"])
    if spec.get("error"):
        try:
            fwd(x, spec["wavelet"], **kw)
        except ValueError as err:
            meta[name] = {"error": str(err)}
            return
        raise AssertionError(f"{name}: no ValueError")

    from ptwt_tpu_torch.parallel import _ring

    # every ring step posted, forward and backward: one collective each
    calls = []
    real = _ring._all_to_all

    def counting(flat, *args):
        calls.append(flat.numel())
        return real(flat, *args)

    runs = ("", "1") if spec.get("schedules") else ("",)
    for schedule in runs:
        os.environ["PTWT_TPU_NO_OVERLAP"] = schedule
        tag = name + ("/no-overlap" if schedule else "")
        xin = x.clone().requires_grad_(bool(spec.get("grad") or spec.get("grad2")))
        if spec.get("data_in") == "shard":
            from ptwt_tpu_torch.parallel.tiledn import _layout, _placements

            dims = _layout(mesh, ("spatial", 1), ("spatial_w", 2) if "spatial_w" in mesh.mesh_dim_names else (None, 0))
            src = distribute_tensor(xin, mesh, _placements(mesh, dims), src_data_rank=None)
        elif spec.get("data_in") == "replicate":
            src = distribute_tensor(xin, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
        else:
            src = xin
        _ring._all_to_all = counting
        try:
            coeffs = fwd(src, spec["wavelet"], **kw)
            bands = leaves(coeffs)
            if spec.get("coeffs_in") == "whole":
                coeffs = type(coeffs)(
                    c.full_tensor() if not isinstance(c, dict) else {k: v.full_tensor() for k, v in c.items()}
                    for c in coeffs
                )
            rec = inv(coeffs, spec["wavelet"], mesh=mesh, mode=spec["mode"])
            grad = grad2 = None
            if spec.get("grad"):
                # every rank's share of the loss: its own bands
                loss = sum((band.to_local() ** 2).sum() for band in bands)
                loss.backward()
                grad = xin.grad.clone()
            if spec.get("grad2"):
                # each rank's share of the gradient is its own chunk's, so
                # the squared gradient is the sum of the shares' squares
                loss = sum((band.to_local() ** 3).sum() for band in bands)
                (share,) = torch.autograd.grad(loss, xin, create_graph=True)
                (grad2,) = torch.autograd.grad((share**2).sum(), xin)
        finally:
            _ring._all_to_all = real
        full = [band.full_tensor() for band in bands]
        rec = rec.full_tensor()
        # each element's gradient lives on the one rank that holds it
        for g in (grad, grad2):
            if g is not None:
                dist.all_reduce(g)
        for i, band in enumerate(full):
            arrays[f"{tag}/band{i}"] = band.detach().numpy()
        arrays[f"{tag}/rec"] = rec.detach().numpy()
        if grad is not None:
            arrays[f"{tag}/grad"] = grad.numpy()
        if grad2 is not None:
            arrays[f"{tag}/grad2"] = grad2.numpy()
        meta[tag] = {"bands": len(full), "p2p_batches": len(calls), "placements": [str(p) for p in bands[0].placements]}


def _compile_case(name, spec, mesh, torch, dist, par, arrays, meta):
    """The case's round trip and the gradient of the sum of its squared
    bands, eager and compiled (``torch.compile(fullgraph=True,
    backend="aot_eager", dynamic=False)``, one graph with the backward):
    the whole bands, reconstruction and gradient of both, and dynamo's
    graph and break counts."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    fwd = getattr(par, FUNCS[spec["kind"]][0])
    inv = getattr(par, FUNCS[spec["kind"]][1])
    x = torch.from_numpy(data(spec))

    def step(t):
        coeffs = fwd(t, spec["wavelet"], level=spec["level"], mesh=mesh, mode=spec["mode"])
        rec = inv(coeffs, spec["wavelet"], mesh=mesh, mode=spec["mode"])
        bands = leaves(coeffs)
        # every rank's share of the loss: its own bands; the backward runs
        # from the loss alone, so the other outputs leave the graph
        loss = sum((band.to_local() ** 2).sum() for band in bands)
        return [band.detach() for band in bands], rec.detach(), loss

    def leaf():
        """The input as a leaf that requires grad: the whole tensor, or
        (``data_in="shard"``) a ``DTensor`` of the transform's layout."""
        if spec.get("data_in") != "shard":
            return x.clone().requires_grad_()
        from ptwt_tpu_torch.parallel.tiledn import _layout, _placements

        placements = _placements(mesh, _layout(mesh, ("spatial", 1)))
        return distribute_tensor(x, mesh, placements, src_data_rank=None).requires_grad_()

    torch._dynamo.reset()
    explained = torch._dynamo.explain(step)(leaf())
    meta[name] = {"graph_breaks": explained.graph_break_count, "graphs": explained.graph_count,
                  "break_reasons": [b.reason[:300] for b in explained.break_reasons]}
    torch._dynamo.reset()
    compiled = torch.compile(step, fullgraph=True, backend="aot_eager", dynamic=False)
    for tag, fn in (("eager", step), ("compiled", compiled)):
        xin = leaf()
        bands, rec, loss = fn(xin)
        (grad,) = torch.autograd.grad(loss, xin)
        if isinstance(grad, DTensor):
            grad = grad.full_tensor()
        else:  # each element's gradient lives on the one rank that holds it
            dist.all_reduce(grad)
        for i, band in enumerate(bands):
            arrays[f"{name}/{tag}/band{i}"] = band.full_tensor().numpy()
        arrays[f"{name}/{tag}/rec"] = rec.full_tensor().numpy()
        arrays[f"{name}/{tag}/grad"] = grad.numpy()
        meta[name]["bands"] = len(bands)
        meta[name]["placements"] = [str(p) for p in bands[0].placements]
    torch._dynamo.reset()


def _part(coeffs, rec, part: str):
    """The output a partial loss takes: ``cA``, level 1's diagonal detail,
    or the reconstruction."""
    return {"approx": coeffs[0], "detail": coeffs[-1][2], "rec": rec}[part]


def _partial_case(name, spec, mesh, torch, dist, par, arrays, meta):
    """Each partial loss (:data:`PARTS`: this rank's share, the sum of the
    squares of one output's local chunk) eager and compiled
    (``fullgraph=True``, ``aot_eager``), its gradient summed over the
    ranks, and dynamo's graph and break counts; every other output leaves
    the compiled function detached.  Then the open fault of a compiled
    forward whose bands leave it needing grad, the loss taken outside:
    its error, or None."""
    fwd, inv = (getattr(par, f) for f in FUNCS[spec["kind"]])
    x = torch.from_numpy(data(spec))
    kw = dict(mesh=mesh, mode=spec["mode"])
    from torch._dynamo.utils import counters

    meta[name] = {}
    for part in PARTS:
        def step(t, part=part):
            coeffs = fwd(t, spec["wavelet"], level=spec["level"], **kw)
            rec = inv(coeffs, spec["wavelet"], **kw)
            loss = (_part(coeffs, rec, part).to_local() ** 2).sum()
            return [b.detach() for b in leaves(coeffs)], rec.detach(), loss

        torch._dynamo.reset()
        counters.clear()
        compiled = torch.compile(step, fullgraph=True, backend="aot_eager", dynamic=False)
        for tag, fn in (("eager", step), ("compiled", compiled)):
            xin = x.clone().requires_grad_()
            _, _, loss = fn(xin)
            loss.backward()
            dist.all_reduce(xin.grad)  # each element's gradient lives on the rank that holds it
            arrays[f"{name}/{part}/{tag}/grad"] = xin.grad.numpy()
        meta[name][part] = {"graph_breaks": sum(counters["graph_break"].values()),
                            "graphs": counters["stats"]["unique_graphs"]}
    # the open fault: the compiled forward returns its bands needing grad
    # and the loss of the approximation's local chunk is taken outside
    torch._dynamo.reset()
    compiled = torch.compile(lambda t: fwd(t, spec["wavelet"], level=spec["level"], **kw), fullgraph=True,
                             backend="aot_eager", dynamic=False)
    try:
        compiled(x.clone().requires_grad_())[0].to_local().square().sum().backward()
        meta[name]["outside"] = None
    except Exception as exc:  # the fault's error, for the parent to pin
        meta[name]["outside"] = f"{type(exc).__name__}: {exc}"
    torch._dynamo.reset()


def main() -> None:
    parser = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        parser.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--suite", "--out"):
        parser.add_argument(flag, required=True)
    args = parser.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=PG_TIMEOUT)
    dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.world, timeout=timeout)
    from ptwt_tpu_torch import parallel as par

    meshes = {}
    arrays, meta = {}, {}
    for name, spec in SUITES[args.suite].items():
        key = json.dumps([spec["mesh"], spec.get("mesh_kw", {})])
        if key not in meshes:
            try:
                meshes[key] = par.make_wavelet_mesh(*spec["mesh"], device_type="cpu", timeout=timeout,
                                                    **spec.get("mesh_kw", {}))
            except ValueError as err:  # a mesh that does not fill the world
                meshes[key] = err
        mesh = meshes[key]
        if isinstance(mesh, ValueError):
            meta[name] = {"error": str(mesh)}
            continue
        run = {"compile": _compile_case, "partial": _partial_case}.get(args.suite, _run_case)
        run(name, spec, mesh, torch, dist, par, arrays, meta)
    assert "jax" not in sys.modules and "ptwt_tpu" not in sys.modules, "a rank imported JAX"
    meta["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ptwt_tpu", "ptwt_tpu_torch"))
    if args.rank == 0:
        np.savez(Path(args.out) / "results.npz", **arrays)
        (Path(args.out) / "results.json").write_text(json.dumps(meta))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
