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
takes it while a ``torch.func`` transform is active.  Both paths stay
until ``torch.func`` takes ``register_autograd`` ops; then the Function
and :func:`call` go.  The once-differentiable marking of
:func:`_once_differentiable` follows
``torch.autograd.function.once_differentiable`` through PyTorch's private
``torch._C._functions.DelayedError``, as that decorator does.
``tests/test_torch_second_order.py`` pins both paths: a second backward
raises under autograd, and under ``torch.func`` a gradient of a gradient
meets ``jax.grad`` of ``jax.grad``, or raises at a VJP op that has no
formula.  There is no fallback: an op that a transform cannot take
raises.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils import _pytree

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
]

#: The namespace of the port's ops.
NAMESPACE = "ptwt_tpu_torch"

#: op -> the ``torch.autograd.Function`` that runs it under ``torch.func``.
_FUNCTIONS: dict = {}


def _tensor_list(tree) -> bool:
    """A pytree leaf: anything but a tuple or a list of tensors."""
    if isinstance(tree, tuple):
        return False
    if isinstance(tree, list):
        return not tree or any(not isinstance(t, torch.Tensor) for t in tree)
    return True


def _optional_tensor_list(tree) -> bool:
    if isinstance(tree, tuple):
        return False
    if isinstance(tree, list):
        return any(t is not None and not isinstance(t, torch.Tensor) for t in tree)
    return True


def _once_differentiable(backward: Callable) -> Callable:
    """``backward`` run with grad disabled, its gradients marked so that
    differentiating them raises (``torch.autograd.function.
    once_differentiable``, for gradients that may come in lists)."""

    @functools.wraps(backward)
    def wrapper(ctx, *cts):
        with torch.no_grad():
            grads = backward(ctx, *cts)
        if not torch.is_grad_enabled() or not any(
            isinstance(c, torch.Tensor) and c.requires_grad for c in _pytree.tree_leaves(cts)
        ):
            return grads
        flat, spec = _pytree.tree_flatten(grads)
        tensors = [i for i, g in enumerate(flat) if isinstance(g, torch.Tensor)]
        if tensors:
            error = torch._C._functions.DelayedError(
                b"a second backward through a kernel's VJP is not ported", len(tensors)
            )
            marked = error(*(flat[i].detach().requires_grad_() for i in tensors))
            for i, g in zip(tensors, marked if isinstance(marked, tuple) else (marked,)):
                flat[i] = g
        return _pytree.tree_unflatten(flat, spec)

    return wrapper


class _Spec:
    """How an op's arguments were flattened into a Function's inputs."""

    def __init__(self, input_spec):
        self.input_spec = input_spec
        self.output_list = False


def _no_context(ctx, inputs, output) -> None:
    pass


def autograd(op, setup_context: Callable = _no_context, backward: Optional[Callable] = None) -> None:
    """Register ``backward`` as ``op``'s autograd formula, and build the
    ``torch.autograd.Function`` that runs ``op`` with it under
    ``torch.func`` (see :func:`call`).  With no ``backward`` (a VJP's op,
    whose own VJP is not ported) differentiating ``op`` raises.  Under
    autograd the backward is differentiable once: a second backward
    raises, as it did when each kernel had its own
    ``once_differentiable`` Function.  Under
    ``torch.func`` the Function runs ``backward`` as it is, so a second
    derivative runs the paired ops' formulas in turn, or raises at a VJP
    that has none.

    ``setup_context(ctx, inputs, output)`` and ``backward(ctx, ct)`` take
    ``register_autograd``'s conventions: ``inputs`` are the op's
    arguments, a list output comes back as one list of cotangents, and
    ``backward`` returns one gradient per argument (a list for a list of
    tensors).
    """
    if backward is None:

        def backward(ctx, *cts):
            raise NotImplementedError(f"a second backward through {NAMESPACE}::{op._name} is not ported")

    op.register_autograd(_once_differentiable(backward), setup_context=setup_context)

    class Function(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*flat):
            spec = flat[-1]
            out = op(*_pytree.tree_unflatten(list(flat[:-1]), spec.input_spec))
            spec.output_list = isinstance(out, list)
            return tuple(out) if spec.output_list else out

        @staticmethod
        def setup_context(ctx, inputs, output):
            spec = inputs[-1]
            ctx.ptwt_spec = spec
            args = _pytree.tree_unflatten(list(inputs[:-1]), spec.input_spec)
            setup_context(ctx, args, list(output) if spec.output_list else output)

        @staticmethod
        def backward(ctx, *cts):
            spec = ctx.ptwt_spec
            needs = ctx.needs_input_grad
            try:
                ctx.needs_input_grad = _pytree.tree_unflatten(list(needs[:-1]), spec.input_spec)
                grads = backward(ctx, list(cts) if spec.output_list else cts[0])
            finally:
                ctx.needs_input_grad = needs
            if not isinstance(grads, tuple):
                grads = (grads,)
            flat, _ = _pytree.tree_flatten(grads, _optional_tensor_list)
            return (*flat, None)

    Function.__name__ = f"{op._name}_function"
    _FUNCTIONS[op] = Function


def call(op, *args):
    """Run ``op`` on ``args``: the op itself (eager autograd and
    ``torch.compile`` take its registered formula and fake), or, while a
    ``torch.func`` transform is active, the Function :func:`autograd`
    built for it."""
    if torch.compiler.is_dynamo_compiling() or not torch._C._are_functorch_transforms_active():
        return op(*args)
    flat, input_spec = _pytree.tree_flatten(args, _tensor_list)
    spec = _Spec(input_spec)
    out = _FUNCTIONS[op].apply(*flat, spec)
    return list(out) if spec.output_list else out


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
