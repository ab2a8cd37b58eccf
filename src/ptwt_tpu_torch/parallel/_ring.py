"""All the communication of :mod:`ptwt_tpu_torch.parallel`.

The JAX package moves its halo slabs with ``lax.ppermute`` and sums its
edge slabs with ``lax.psum`` inside ``shard_map``; here both run on the
process group of one axis of a
:class:`~torch.distributed.device_mesh.DeviceMesh`:

* :func:`ring_shift` / :func:`exchange`: ring steps through
  ``dist.batch_isend_irecv`` (one ``isend`` and one ``irecv`` per slab),
  differentiable to any order: the backward of a ring step is the
  opposite ring step, itself differentiable, as the VJP of ``ppermute`` is
  ``ppermute`` by the inverse permutation.
  :func:`start_exchange` posts the steps and returns at once, so that a
  caller can launch work that needs no halo before it waits
  (:meth:`Pending.wait`).
* :func:`edge_sum`: the edge-slab sum (``psum``), an all-reduce whose
  backward is the (differentiable) all-reduce of the cotangents.

On an axis of size 1 every one of them is the identity and makes no call
at all (``ppermute`` on an axis of size 1 is the identity too; gloo also
refuses a send to oneself).

The transport follows ``dist.get_backend(group)``, never a caught error:

* ``nccl`` carries CUDA tensors as they are;
* ``gloo`` with a CUDA tensor: gloo's send and receive take CPU tensors
  only (a CUDA tensor fails in the transport, "writev ... Bad address",
  and takes the process down), so a slab is copied to a pinned host
  buffer (the stream is synchronised once before the sends), received
  into a pinned host buffer and copied back to the card after the wait;
  gloo's all-reduce takes CUDA tensors as they are;
* ``gloo`` with a CPU tensor sends it as it is.

A failed exchange raises.  :data:`EXCHANGE_LOG`, when set to a list,
records the bytes this process sends, for the measurements of
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "BWD",
    "FWD",
    "EXCHANGE_LOG",
    "Exchange",
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


class Exchange:
    """Ring steps of one mesh axis in flight: one slab per direction entry.

    :meth:`post` issues every ``isend``/``irecv`` at once and returns;
    :meth:`finish` waits for them and returns the received slabs, on the
    slabs' device.
    """

    def __init__(self, group, size: int, index: int, directions: Sequence[int], axis_name: str = ""):
        self.group, self.size, self.index, self.axis_name = group, size, index, axis_name
        self.directions = tuple(directions)
        self.works: list = []
        self.sends: list[torch.Tensor] = []
        self.received: list[torch.Tensor] = []
        self.staged = False
        self.device = None
        self.cts = None

    @classmethod
    def on_axis(cls, mesh, axis_name: str, directions: Sequence[int]) -> "Exchange":
        """The ring steps of ``mesh``'s axis ``axis_name`` for this rank."""
        return cls(mesh.get_group(axis_name), axis_size(mesh, axis_name),
                   mesh.get_local_rank(axis_name), directions, axis_name)

    def reversed(self) -> "Exchange":
        """The opposite ring steps on the same group."""
        return Exchange(self.group, self.size, self.index, [-d for d in self.directions], self.axis_name)

    def _peer(self, step: int) -> int:
        return dist.get_global_rank(self.group, (self.index + step) % self.size)

    def post(self, slabs: Sequence[torch.Tensor]) -> None:
        """Issue one ``isend`` and one ``irecv`` per slab and return."""
        self.device = slabs[0].device
        staged = _staged(self.group, slabs[0])
        if staged:
            sends = []
            for s in slabs:
                host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                host.copy_(s, non_blocking=True)
                sends.append(host)
            torch.cuda.current_stream(self.device).synchronize()
            self.received = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True) for s in slabs]
        else:
            sends = [s.contiguous() for s in slabs]
            self.received = [torch.empty_like(s) for s in sends]
        self.staged = staged
        self.sends = sends  # alive until the wait
        ops = []
        # one tag per slab, and every rank lists the slabs in one order, so
        # two slabs between the same two ranks (an axis of size 2) match
        for tag, (send, recv, step) in enumerate(zip(sends, self.received, self.directions)):
            ops.append(dist.P2POp(dist.isend, send, self._peer(step), self.group, tag))
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(-step), self.group, tag))
        if EXCHANGE_LOG is not None:
            EXCHANGE_LOG.append((self.axis_name, [(step, _nbytes(send)) for send, step in zip(sends, self.directions)]))
        self.works = dist.batch_isend_irecv(ops)

    def finish(self) -> list[torch.Tensor]:
        """Wait for the steps; the received slabs, on the slabs' device."""
        for work in self.works:
            work.wait()
        self.works, self.sends = [], []
        if self.staged:
            return [r.to(self.device, non_blocking=True) for r in self.received]
        return self.received


class _Post(torch.autograd.Function):
    """Posts the ring steps; its output is an empty token that orders
    :class:`_Finish` after it.  Backward: the opposite ring steps of the
    received slabs' cotangents, which :class:`_Finish` left behind."""

    @staticmethod
    def forward(ctx, ex: Exchange, *slabs):
        ex.post(slabs)
        ctx.ex = ex
        return slabs[0].new_empty(0)

    @staticmethod
    def backward(ctx, _token):
        ex = ctx.ex
        cts, ex.cts = ex.cts, None
        # through the Functions again, so that a second derivative runs
        # the steps back once more
        back = ex.reversed()
        return (None, *_Finish.apply(back, _Post.apply(back, *cts)))


class _Finish(torch.autograd.Function):
    """Waits for the ring steps and returns the received slabs."""

    @staticmethod
    def forward(ctx, ex: Exchange, token):
        ctx.ex = ex
        ctx.token = (token.dtype, token.device)
        return tuple(ex.finish())

    @staticmethod
    def backward(ctx, *cts):
        ctx.ex.cts = cts
        dtype, device = ctx.token
        return None, torch.zeros(0, dtype=dtype, device=device)


class Pending:
    """Ring steps posted by :func:`start_exchange`; :meth:`wait` returns
    the received slabs (differentiable)."""

    def __init__(self, ex, token, slabs):
        self._ex, self._token, self._slabs = ex, token, slabs

    def wait(self) -> list[torch.Tensor]:
        """The received slabs, one per posted slab."""
        if self._ex is None:  # an axis of size 1
            return list(self._slabs)
        return list(_Finish.apply(self._ex, self._token))


def start_exchange(slabs: Sequence[torch.Tensor], directions: Sequence[int], axis_name: str, mesh) -> Pending:
    """Post one ring step per slab (``FWD`` or ``BWD``) on ``axis_name``'s
    group and return without waiting.  On an axis of size 1 nothing is
    posted and the wait returns the slabs themselves."""
    if axis_size(mesh, axis_name) == 1:
        return Pending(None, None, slabs)
    ex = Exchange.on_axis(mesh, axis_name, directions)
    return Pending(ex, _Post.apply(ex, *slabs), slabs)


def exchange(slabs: Sequence[torch.Tensor], directions: Sequence[int], axis_name: str, mesh) -> list[torch.Tensor]:
    """One ring step per slab on ``axis_name``, all in one batch; returns
    the received slabs.  Differentiable."""
    return start_exchange(slabs, directions, axis_name, mesh).wait()


def ring_shift(t: torch.Tensor, axis_name: str, mesh, direction: int) -> torch.Tensor:
    """One ring step of ``t`` along ``axis_name``: with ``FWD`` rank ``i``
    gets rank ``i - 1``'s tensor (``ppermute`` by ``[(i, i + 1)]``).  Its
    backward is the opposite step; on an axis of size 1 it returns ``t``
    and makes no call."""
    return exchange([t], [direction], axis_name, mesh)[0]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` in a new tensor."""
    _staged(group, t)  # checks the backend and the device
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """The sum over the group; backward: the sum of the cotangents (what
    ``torch.distributed.nn.functional.all_reduce``, deprecated since torch
    2.13, computes)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, ct):
        return _AllReduce.apply(ct, ctx.group), None


def edge_sum(t: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis_name`` (``lax.psum``),
    differentiable; the identity on an axis of size 1."""
    if axis_size(mesh, axis_name) == 1:
        return t
    if EXCHANGE_LOG is not None:
        EXCHANGE_LOG.append((axis_name, [(0, _nbytes(t))]))
    return _AllReduce.apply(t, mesh.get_group(axis_name))
