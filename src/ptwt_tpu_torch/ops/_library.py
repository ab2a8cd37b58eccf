"""The kernels as ``torch.library`` custom ops: how they meet the transforms.

Every kernel launch of the port goes through one custom op in the
``ptwt_tpu_torch`` namespace (``torch.ops.ptwt_tpu_torch.*``), defined
beside its launch glue.  An op's implementation is that glue: it checks
its tensors, plans the launch and calls :func:`._kernels.launch`, which
counts it.  The op is opaque to ``torch.compile``, so a compiled
transform keeps every launch; each op has

* a fake implementation (``register_fake``): the output shapes and
  dtypes from the geometry its arguments carry, so ``torch.compile``
  traces it without a card;
* an autograd formula (``register_autograd``, through :func:`autograd`):
  its backward is the paired op, as the JAX package's ``custom_vjp``s
  pair its kernels;
* a batching rule (``register_vmap``): the vmapped dimension goes into
  the leading batch axis every kernel takes, so a ``torch.func.vmap`` of
  a transform launches each kernel once, as the batched call does.

``torch.func.grad`` cannot run an op's ``register_autograd`` formula: in
PyTorch 2.13 (``torch/_library/autograd.py``) the function built from it
has an old-style ``forward(ctx, *args)`` and no ``setup_context``, which
``torch.func`` refuses.  So :func:`autograd` also builds a
``torch.autograd.Function`` from the same two functions, and :func:`call`
takes it while a ``torch.func`` transform is active, eagerly and under
``torch.compile`` alike.  The Function is ``allow_in_graph``: dynamo
writes one call of it into its graph (its arguments flattened by a tuple
of ints, a constant of the graph), and AOTAutograd traces that call with
the transforms, down to the op, which stays opaque.  So ``torch.compile``
of ``torch.func.grad``, of grad of grad and of ``vmap`` of grad launches
what eager ``torch.func`` launches.  Both paths stay until ``torch.func``
takes ``register_autograd`` ops; then the Function and :func:`call` go.

Every op is linear in its tensors (bilinear for ``tap_grad``, the taps'
gradient), and every backward is a formula of ops, each with its own
formula: so on both paths a backward that runs with grad enabled
(``create_graph=True``, or an outer ``torch.func.grad``) records its
launches, and a gradient differentiates again to any order.
``tests/test_torch_second_order.py`` holds a gradient of a gradient
against ``jax.grad`` of ``jax.grad`` on both paths.  There is no
fallback: an op that a transform cannot take raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch._subclasses.functional_tensor import FunctionalTensor

__all__ = [
    "NAMESPACE",
    "autograd",
    "batch_first",
    "call",
    "constant_tensor",
    "flatten_batch",
    "flatten_list",
    "no_batched",
    "split_batch",
    "traced",
]

#: The namespace of the port's ops.
NAMESPACE = "ptwt_tpu_torch"

#: op -> the ``torch.autograd.Function`` that runs it under ``torch.func``.
_FUNCTIONS: dict = {}


def _layout(args) -> tuple:
    """How :func:`call` flattens an op's arguments into a Function's
    inputs: for each argument the length of its list of tensors, or -1
    where it is anything else (a tensor, None, a number, a list of
    numbers).  A tuple of ints, so ``torch.compile`` keeps it as a
    constant of the graph."""
    return tuple(
        len(a) if isinstance(a, list) and a and all(isinstance(t, torch.Tensor) for t in a) else -1
        for a in args
    )


def _flatten(args, layout) -> list:
    flat = []
    for a, n in zip(args, layout):
        if n < 0:
            flat.append(a)
        else:
            flat.extend([None] * n if a is None else a)
    return flat


def _unflatten(flat, layout) -> list:
    args, i = [], 0
    for n in layout:
        args.append(flat[i] if n < 0 else list(flat[i : i + n]))
        i += 1 if n < 0 else n
    return args


def autograd(op, setup_context: Callable, backward: Callable) -> None:
    """Register ``backward`` as ``op``'s autograd formula, and build the
    ``torch.autograd.Function`` that runs ``op`` with it under
    ``torch.func`` (see :func:`call`).  Both run ``backward`` as it is, so
    a second derivative runs the paired ops' formulas in turn.

    ``setup_context(ctx, inputs, output)`` and ``backward(ctx, ct)`` take
    ``register_autograd``'s conventions: ``inputs`` are the op's
    arguments, a list output comes back as one list of cotangents, and
    ``backward`` returns one gradient per argument (a list for a list of
    tensors).
    """
    op.register_autograd(backward, setup_context=setup_context)
    output_list = isinstance(op._opoverload._schema.returns[0].type, torch.ListType)

    class Function(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*flat):
            out = op(*_unflatten(flat[:-1], flat[-1]))
            return tuple(out) if output_list else out

        @staticmethod
        def setup_context(ctx, inputs, output):
            layout = inputs[-1]
            ctx.ptwt_layout = layout
            setup_context(ctx, _unflatten(inputs[:-1], layout), list(output) if output_list else output)

        @staticmethod
        def backward(ctx, *cts):
            layout = ctx.ptwt_layout
            needs = ctx.needs_input_grad
            try:
                ctx.needs_input_grad = _unflatten(needs[:-1], layout)
                grads = backward(ctx, list(cts) if output_list else cts[0])
            finally:
                ctx.needs_input_grad = needs
            if not isinstance(grads, tuple):
                grads = (grads,)
            return (*_flatten(grads, layout), None)

    Function.__name__ = f"{op._name}_function"
    # Under torch.compile of a torch.func transform, dynamo writes the
    # Function into its graph as one call, and AOTAutograd traces it with
    # the transforms: its forward reaches the op, which stays opaque.
    torch._dynamo.allow_in_graph(Function)
    _FUNCTIONS[op] = Function


def call(op, *args):
    """Run ``op`` on ``args``: the op itself (eager autograd and
    ``torch.compile`` take its registered formula and fake), or, while a
    ``torch.func`` transform is active, eager or compiled, the Function
    :func:`autograd` built for it."""
    if not torch._C._are_functorch_transforms_active():
        return op(*args)
    layout = _layout(args)
    out = _FUNCTIONS[op].apply(*_flatten(args, layout), layout)
    return list(out) if isinstance(out, tuple) else out


def constant_tensor(t):
    """``t``, a tensor made to be kept for later calls (a cached operator
    or plan), with every ``torch.func`` wrapper taken off: made while a
    transform runs, it would be that transform's, and a later call would
    find it escaped.  Anything else comes back as it is."""
    if not isinstance(t, torch.Tensor) or torch.compiler.is_dynamo_compiling():
        return t
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def traced(t) -> bool:
    """Whether ``t`` stands in for data in a trace: a fake or functional
    tensor (under any ``torch.func`` wrappers), as ``torch.compile``'s
    tracers run a backward formula on them.  A tensor made for such a
    call is a constant of that trace and goes into no cache."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return isinstance(t, (FakeTensor, FunctionalTensor))


# ---------------------------------------------------------------------------
# batching helpers for the ops' vmap rules
# ---------------------------------------------------------------------------


def batch_first(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``t`` with its vmapped dimension ``dim`` first (expanded to ``size``
    where ``dim`` is None)."""
    if dim is None:
        return t.expand(size, *t.shape)
    return t.movedim(dim, 0)


def flatten_batch(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``t`` of a kernel whose leading axis is its batch, with the vmapped
    dimension folded into that axis: ``[V * B, ...]``, contiguous."""
    t = batch_first(t, dim, size)
    return t.reshape(size * t.shape[1], *t.shape[2:]).contiguous()


def split_batch(t: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """Undo :func:`flatten_batch` on a kernel's output whose batch is axis
    ``axis``: ``[..., V * B, ...]`` -> ``[..., V, B, ...]``."""
    return t.reshape(*t.shape[:axis], size, -1, *t.shape[axis + 1 :])


def flatten_list(ts, dims, size: int) -> list:
    """:func:`flatten_batch` on each tensor of a list argument (``dims``
    its in_dims entry, None where no tensor of it is vmapped)."""
    return [flatten_batch(t, d, size) for t, d in zip(ts, dims or [None] * len(ts))]


def no_batched(name: str, in_dims, *which: int) -> None:
    """Raise where an argument that one launch cannot batch is vmapped."""
    for i in which:
        dim = in_dims[i]
        if dim is not None and (not isinstance(dim, list) or any(d is not None for d in dim)):
            raise NotImplementedError(
                f"{NAMESPACE}::{name} cannot vmap over its argument {i} in one launch"
            )
