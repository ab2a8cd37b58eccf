"""Deprecated-kwarg aliases.

Counterpart of :mod:`ptwt_tpu.utils._deprecation`: code written for older
releases may still pass ``boundary=`` to the matrix transforms.  The old
name maps onto the new one with a ``DeprecationWarning``, and passing both
raises ``TypeError``.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

__all__ = ["deprecated_alias"]


def deprecated_alias(**aliases: str) -> Callable[[F], F]:
    """Accept renamed keyword arguments under their deprecated names.

    Use as ``@deprecated_alias(old_name="new_name")``.  A call passing
    ``old_name=`` is rewritten to ``new_name=`` with a
    ``DeprecationWarning``; passing both names raises ``TypeError``.
    """

    def deco(func: F) -> F:
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            name = func.__qualname__.replace(".__init__", "")
            for old, new in aliases.items():
                if old in kwargs:
                    if new in kwargs:
                        raise TypeError(
                            f"{name} received both {old} and {new} "
                            f"as arguments! {old} is deprecated, use {new} "
                            "instead."
                        )
                    warnings.warn(
                        f"`{old}` is deprecated as an argument to "
                        f"`{name}`; use `{new}` instead.",
                        DeprecationWarning,
                        stacklevel=2,
                    )
                    kwargs[new] = kwargs.pop(old)
            return func(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return deco
