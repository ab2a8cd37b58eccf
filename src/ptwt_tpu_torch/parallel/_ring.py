"""All the communication of :mod:`ptwt_tpu_torch.parallel`.

The JAX package moves its halo slabs with ``lax.ppermute`` and sums its
edge slabs with ``lax.psum`` inside ``shard_map``; here both are
functional collectives (``torch.ops._c10d_functional``) on the process
group of one axis of a :class:`~torch.distributed.device_mesh.DeviceMesh`,
which ``torch.compile`` traces into its graph as ``jax.jit`` traces
``ppermute`` and ``psum``:

* :func:`ring_shift` / :func:`exchange`: ring steps, a permutation of the
  axis's ranks as ``ppermute`` is.  The slabs of one exchange are packed
  into one buffer and go in one ``all_to_all_single``, each slab's part
  of the buffer addressed to its neighbour (the split sizes are the
  slabs' element counts, python ints on every rank).  The backward of a
  ring step is the opposite ring step, itself differentiable, so ring
  steps differentiate to any order, as the VJP of ``ppermute`` is
  ``ppermute`` by the inverse permutation.
  :func:`start_exchange` posts the steps and returns at once (the
  collective's output, not yet waited for), so that a caller can launch
  work that needs no halo before it waits (:meth:`Pending.wait`, the
  collective's ``wait_tensor``).  Compiled, the wait is the graph's
  ``wait_tensor`` node, in the same place.
* :func:`edge_sum`: the edge-slab sum (``psum``), an all-reduce whose
  backward is the (differentiable) all-reduce of the cotangents.

Both are ``torch.autograd.Function`` s whose state is the group's name and
the split sizes, python constants, so eager autograd and
``torch.compile`` (forward and backward) run the same code.

On an axis of size 1 every one of them is the identity and makes no call
at all (``ppermute`` on an axis of size 1 is the identity too).

The transport follows ``dist.get_backend(group)``, never a caught error:

* ``nccl`` carries CUDA tensors as they are;
* ``gloo`` with a CUDA tensor: gloo's transfers take CPU tensors only (a
  CUDA tensor in a send fails in the transport, "writev ... Bad address",
  and takes the process down), so the packed slabs are copied to host
  memory (``.cpu()``) before the step and the received buffer back to the
  card (``.to(device)``) after the wait, compiled too; gloo's all-reduce
  takes CUDA tensors as they are;
* ``gloo`` with a CPU tensor sends it as it is.

A failed exchange raises.  :data:`EXCHANGE_LOG`, when set to a list,
records the bytes this process sends, for the measurements of
``chip_smoke.py``: every exchange and edge sum of every call, eager or
compiled (``torch.compile`` records the appends when it traces and replays
them after each call of the graph; setting the log to a list or back to
None makes a compiled transform recompile).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "BWD",
    "FWD",
    "EXCHANGE_LOG",
    "Pending",
    "axis_size",
    "edge_sum",
    "exchange",
    "ring_shift",
    "start_exchange",
]

#: Ring directions: with ``FWD`` rank ``i`` of the axis sends to ``i + 1``
#: and receives from ``i - 1`` (``ppermute`` by ``[(i, i + 1)]``); ``BWD``
#: the opposite.
FWD = 1
BWD = -1

#: When a list, each exchange this process posts appends ``(axis name,
#: [(direction, bytes sent), ...])`` to it (one entry per ring level), and
#: each edge sum ``(axis name, [(0, bytes summed)])``.
EXCHANGE_LOG: Optional[list] = None

_C10D = torch.ops._c10d_functional


def axis_size(mesh, axis_name: str) -> int:
    """The number of ranks along ``axis_name`` of ``mesh``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis_name)]


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a slab goes through host memory, from the group's backend."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"an nccl group carries CUDA tensors, not {t.device}")
        return False
    if backend == "gloo":
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {t.device}: use a CPU or CUDA tensor")
        return t.device.type == "cuda"
    raise ValueError(f"unsupported process group backend {backend!r}: use nccl or gloo")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _log(axis_name: str, entries: list) -> None:
    if EXCHANGE_LOG is not None:
        EXCHANGE_LOG.append((axis_name, entries))


def _all_to_all(flat: torch.Tensor, out_splits: list, in_splits: list, group_name: str) -> torch.Tensor:
    """Post one ring step's ``all_to_all_single``; its output is valid only
    after :class:`_Wait`."""
    return _C10D.all_to_all_single(flat, out_splits, in_splits, group_name)


def _all_reduce(t: torch.Tensor, group_name: str) -> torch.Tensor:
    """The sum of ``t`` over the group, waited for."""
    return _C10D.wait_tensor(_C10D.all_reduce(t.contiguous(), "sum", group_name))


class _Wait(torch.autograd.Function):
    """The wait for a posted collective; the identity to autograd."""

    @staticmethod
    def forward(ctx, t):
        return _C10D.wait_tensor(t)

    @staticmethod
    def backward(ctx, ct):
        return ct


class _AllToAll(torch.autograd.Function):
    """Posts a packed ring step (the output is waited for by
    :class:`_Wait`).  Backward: the opposite step, the split sizes swapped,
    posted and waited for through the Functions again, so that a second
    derivative runs the steps back once more."""

    @staticmethod
    def forward(ctx, flat, out_splits: list, in_splits: list, group_name: str):
        ctx.back = (in_splits, out_splits, group_name)
        return _all_to_all(flat, out_splits, in_splits, group_name)

    @staticmethod
    def backward(ctx, ct):
        return _Wait.apply(_AllToAll.apply(ct.contiguous(), *ctx.back)), None, None, None


class Pending:
    """Ring steps posted by :func:`start_exchange`; :meth:`wait` returns
    the received slabs (differentiable)."""

    def __init__(self, received, shapes=(), order=(), device=None):
        # an axis of size 1: ``received`` are the slabs themselves;
        # otherwise the posted buffer, the slabs' shapes, the order in
        # which they arrive in it, and the card to copy it back to (gloo)
        self._received, self._shapes, self._order, self._device = received, shapes, order, device

    def wait(self) -> list[torch.Tensor]:
        """The received slabs, one per posted slab."""
        if not self._order:
            return list(self._received)
        flat = _Wait.apply(self._received)
        if self._device is not None:
            flat = flat.to(self._device)
        parts = flat.split([self._shapes[k].numel() for k in self._order])
        slabs = [None] * len(self._order)
        for k, part in zip(self._order, parts):
            slabs[k] = part.view(self._shapes[k])
        return slabs


def _start(slabs: Sequence[torch.Tensor], directions: Sequence[int], axis_name: str, mesh) -> Pending:
    """Pack the slabs by destination and post their ring steps."""
    size = axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name)
    index = mesh.get_local_rank(axis_name)
    staged = _staged(group, slabs[0])
    # every rank lists the slabs in one order and the slab shapes agree, so
    # the slabs from one source arrive in the order that source packed
    # them (two slabs between the same two ranks on an axis of size 2)
    send = sorted(range(len(slabs)), key=lambda k: ((index + directions[k]) % size, k))
    recv = sorted(range(len(slabs)), key=lambda k: ((index - directions[k]) % size, k))
    in_splits, out_splits = [0] * size, [0] * size
    for s, step in zip(slabs, directions):
        in_splits[(index + step) % size] += s.numel()
        out_splits[(index - step) % size] += s.numel()
    flat = torch.cat([slabs[k].reshape(-1) for k in send])
    device = None
    if staged:
        device = flat.device
        flat = flat.cpu()
    _log(axis_name, [(step, _nbytes(s)) for s, step in zip(slabs, directions)])
    posted = _AllToAll.apply(flat, out_splits, in_splits, group.group_name)
    return Pending(posted, [s.shape for s in slabs], recv, device)


def start_exchange(slabs: Sequence[torch.Tensor], directions: Sequence[int], axis_name: str, mesh) -> Pending:
    """Post one ring step per slab (``FWD`` or ``BWD``) on ``axis_name``'s
    group and return without waiting.  On an axis of size 1 nothing is
    posted and the wait returns the slabs themselves."""
    if axis_size(mesh, axis_name) == 1:
        return Pending(slabs)
    return _start(slabs, directions, axis_name, mesh)


def exchange(slabs: Sequence[torch.Tensor], directions: Sequence[int], axis_name: str, mesh) -> list[torch.Tensor]:
    """One ring step per slab on ``axis_name``, all in one collective;
    returns the received slabs.  Differentiable."""
    return start_exchange(slabs, directions, axis_name, mesh).wait()


def ring_shift(t: torch.Tensor, axis_name: str, mesh, direction: int) -> torch.Tensor:
    """One ring step of ``t`` along ``axis_name``: with ``FWD`` rank ``i``
    gets rank ``i - 1``'s tensor (``ppermute`` by ``[(i, i + 1)]``).  Its
    backward is the opposite step; on an axis of size 1 it returns ``t``
    and makes no call."""
    return exchange([t], [direction], axis_name, mesh)[0]


class _AllReduce(torch.autograd.Function):
    """The sum over the group; backward: the sum of the cotangents."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group_name: str):
        ctx.group_name = group_name
        return _all_reduce(t, group_name)

    @staticmethod
    def backward(ctx, ct):
        return _AllReduce.apply(ct, ctx.group_name), None


def edge_sum(t: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis_name`` (``lax.psum``),
    differentiable; the identity on an axis of size 1."""
    if axis_size(mesh, axis_name) == 1:
        return t
    group = mesh.get_group(axis_name)
    _staged(group, t)  # checks the backend and the device
    _log(axis_name, [(0, _nbytes(t))])
    return _AllReduce.apply(t, group.group_name)
