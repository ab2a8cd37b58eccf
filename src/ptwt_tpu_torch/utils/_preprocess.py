"""Axes/batch preprocessing, filter arrays and coefficient-tree helpers.

Counterpart of :mod:`ptwt_tpu.utils._preprocess`: the transform axes are
moved to the back and every leading axis is folded into one batch axis,
so the level ops always see ``[batch, *spatial]``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Sequence, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..constants import Wavelet, WaveletDetailTuple2d, WaveletTensorTuple

AxesArg = Union[int, Sequence[int], None]


def host_constant(maxsize: int) -> Callable:
    """Decorator: cache a function's results (the last ``maxsize``
    argument tuples), and have ``torch.compile`` take each as a constant
    of the program.  The function runs on the host, once per arguments,
    as the JAX package's numpy work runs once at ``jax.jit``'s trace."""

    def decorate(fn: Callable) -> Callable:
        def kept(*args):
            from ..ops._library import constant_tensor

            # a tensor it makes is kept past the transform that may be running
            return tree_map(constant_tensor, fn(*args))

        # host work is never traced, also where a caller resumes past a graph break
        cached = torch.compiler.disable(functools.lru_cache(maxsize=maxsize)(kept))

        @torch.compiler.assume_constant_result
        @functools.wraps(fn)
        def constant(*args):
            return cached(*args)

        return constant

    return decorate


def check_axes_argument(axes: Sequence[int]) -> None:
    """Raise if an axis is repeated."""
    if len(set(axes)) != len(axes):
        raise ValueError("Cant transform the same axis twice.")


def _normalize_axes(axes: AxesArg, ndim: int) -> tuple[int, ...]:
    if axes is None:
        axes = tuple(range(-ndim, 0))
    elif isinstance(axes, int):
        axes = (axes,)
    else:
        axes = tuple(axes)
    if len(axes) != ndim:
        raise ValueError(f"{ndim}d transforms work with {ndim} axes.")
    return axes


def _transpose_order(axes: Sequence[int], ndim: int) -> list[int]:
    axes = [a + ndim if a < 0 else a for a in axes]
    return [a for a in range(ndim) if a not in axes] + list(axes)


@host_constant(maxsize=256)
def _inverse_order(axes: tuple[int, ...], ndim: int) -> tuple[int, ...]:
    """The permutation that undoes :func:`swap_axes` (host work, cached)."""
    return tuple(np.argsort(_transpose_order(axes, ndim)).tolist())


def swap_axes(data: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Move the transform axes to the end (keeping their given order)."""
    check_axes_argument(axes)
    return data.permute(_transpose_order(axes, data.ndim))


def undo_swap_axes(data: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Invert :func:`swap_axes`."""
    check_axes_argument(axes)
    return data.permute(_inverse_order(tuple(axes), data.ndim))


def _is_default_axes(axes: Sequence[int], ndim: int) -> bool:
    return tuple(axes) == tuple(range(-ndim, 0))


def preprocess_tensor(
    data: torch.Tensor, ndim: int, axes: AxesArg
) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Normalize ``data`` to shape ``[batch, *spatial]`` with ndim spatial axes.

    Returns:
        ``(folded_data, ds)`` where ``ds`` is the shape after the axis swap,
        needed to undo the folding.
    """
    axes = _normalize_axes(axes, ndim)
    if data.ndim < ndim:
        raise ValueError(
            f"At least {ndim} input dimensions are required, got {data.ndim}."
        )
    if not _is_default_axes(axes, data.ndim):
        data = swap_axes(data, axes)
    ds = tuple(data.shape)
    batch = math.prod(ds[:-ndim]) if data.ndim > ndim else 1
    return data.reshape(batch, *ds[-ndim:]), ds


def postprocess_tensor(
    data: torch.Tensor, ndim: int, ds: tuple[int, ...], axes: AxesArg
) -> torch.Tensor:
    """Invert :func:`preprocess_tensor` (unfold batch, undo axis swap)."""
    axes = _normalize_axes(axes, ndim)
    data = data.reshape(*ds[: len(ds) - ndim], *data.shape[1:])
    if not _is_default_axes(axes, data.ndim):
        data = undo_swap_axes(data, axes)
    return data


def coeff_tree_map(fn: Callable[[Any], Any], coeffs: Any) -> Any:
    """Apply ``fn`` to every leaf, preserving lists, tuples, NamedTuples
    and dicts (a dict comes back with its keys sorted, as JAX's pytree map
    returns it)."""
    if isinstance(coeffs, dict):
        return {key: coeff_tree_map(fn, coeffs[key]) for key in sorted(coeffs)}
    if isinstance(coeffs, tuple) and hasattr(coeffs, "_fields"):
        return type(coeffs)(*(coeff_tree_map(fn, v) for v in coeffs))
    if isinstance(coeffs, (list, tuple)):
        return type(coeffs)(coeff_tree_map(fn, v) for v in coeffs)
    return fn(coeffs)


def preprocess_coeffs(coeffs, ndim: int, axes: AxesArg):
    """Normalize every coefficient tensor to ``[batch, *spatial]``.

    Returns the processed container and ``ds`` (the swapped shape of the
    approximation coefficients including leading axes) to undo the folding.
    """
    axes = _normalize_axes(axes, ndim)
    approx = coeffs[0]
    if not isinstance(approx, torch.Tensor):
        raise ValueError(
            "First element of coeffs must be the approximation coefficient tensor."
        )
    if approx.ndim < ndim:
        raise ValueError(
            f"At least {ndim} input dimensions are required, got {approx.ndim}."
        )
    ndim_total = approx.ndim
    default = _is_default_axes(axes, ndim_total)

    def _one(arr: torch.Tensor) -> torch.Tensor:
        if arr.ndim != ndim_total:
            raise ValueError(
                "All coefficients must have the same number of dimensions."
            )
        if not default:
            arr = swap_axes(arr, axes)
        shape = arr.shape
        batch = math.prod(shape[:-ndim]) if arr.ndim > ndim else 1
        return arr.reshape(batch, *shape[-ndim:])

    ds = tuple(approx.shape if default else swap_axes(approx, axes).shape)
    return coeff_tree_map(_one, coeffs), ds


def postprocess_coeffs(coeffs, ndim: int, ds: tuple[int, ...], axes: AxesArg):
    """Invert :func:`preprocess_coeffs` on every coefficient tensor."""
    axes = _normalize_axes(axes, ndim)
    lead = ds[: len(ds) - ndim]

    def _one(arr: torch.Tensor) -> torch.Tensor:
        arr = arr.reshape(*lead, *arr.shape[1:])
        if not _is_default_axes(axes, arr.ndim):
            arr = undo_swap_axes(arr, axes)
        return arr

    return coeff_tree_map(_one, coeffs)


#: The numpy dtype of each torch dtype a filter bank is cast to.
_NUMPY_DTYPES = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


def numpy_dtype(dtype: torch.dtype) -> type:
    """The numpy dtype of a floating torch ``dtype`` (read from a fixed
    map: a tensor made to ask would have no storage under ``torch.func``)."""
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise TypeError(f"filter banks take float16, float32 or float64, got {dtype}") from None


@host_constant(maxsize=1024)
def constant_taps(taps: tuple, flip: bool, dtype: torch.dtype) -> tuple[float, ...]:
    """A constant filter's taps as python floats of ``dtype``'s precision,
    flipped where asked, made once per filter and cached.

    Host work: ``torch.compile`` takes the result as a constant, as
    ``jax.jit`` takes the JAX package's numpy banks."""
    arr = np.asarray(taps, dtype=numpy_dtype(dtype))
    return tuple(float(v) for v in (arr[::-1] if flip else arr))


@host_constant(maxsize=256)
def _named_bank(name: str, flip: bool, dtype: torch.dtype) -> tuple[tuple[float, ...], ...]:
    """The four filters of a named wavelet as :func:`constant_taps` makes
    them, built once per name (the registry's numpy work stays out of a
    traced program)."""
    from ..wavelets import Wavelet

    return tuple(constant_taps(tuple(f), flip, dtype) for f in Wavelet(name).filter_bank)


def filter_taps(
    wavelet: Union[Wavelet, str, WaveletTensorTuple, tuple],
    flip: bool,
    dtype: torch.dtype = torch.float32,
) -> tuple:
    """``(dec_lo, dec_hi, rec_lo, rec_hi)`` as the transforms take them.

    Constant filters (a wavelet name, a pywt-style wavelet, sequences of
    numbers) come back as tuples of python floats rounded to ``dtype``,
    cached: the kernels take them as host constants, and
    ``torch.compile`` as constants of the program.  Filters given as
    tensors stay tensors (cast to ``dtype``), keeping a gradient path into
    filters that require grad; each is a tensor of this call's own, and
    in eager mode the taps of those on the card are read to the host once,
    in one copy, for the kernels' launches (compiled, each op reads them).
    Analysis filters come flipped (correlation order) with ``flip=True``.
    """
    from ..ops._kernels import keep_host_taps

    if isinstance(wavelet, str):
        return _named_bank(wavelet, flip, dtype)
    if isinstance(wavelet, tuple) and len(wavelet) == 4:
        bank = wavelet
    else:
        bank = wavelet.filter_bank

    def _conv(filt):
        if isinstance(filt, torch.Tensor):
            arr = filt.to(dtype)
            if flip:
                return arr.flip(-1)
            return arr.view_as(arr) if arr is filt else arr
        if isinstance(filt, np.ndarray):
            filt = filt.ravel().tolist()
        return constant_taps(tuple(filt), flip, dtype)

    filters = tuple(_conv(f) for f in bank)
    if not torch.compiler.is_compiling():
        keep_host_taps(filters)
    return filters


def get_filter_arrays(
    wavelet: Union[Wavelet, str, WaveletTensorTuple, tuple],
    flip: bool,
    dtype: torch.dtype = torch.float32,
) -> tuple:
    """Return ``(dec_lo, dec_hi, rec_lo, rec_hi)`` as 1d arrays.

    Accepts a wavelet name, any object with ``.filter_bank`` (a pywt-style
    wavelet), or a tuple of four filter arrays.  Static banks come back as
    **numpy** arrays of ``dtype`` (the values of :func:`filter_taps`).
    Filters given as tensors stay tensors, as :func:`filter_taps` returns
    them.  Analysis filters come flipped (correlation order) with
    ``flip=True``.
    """
    np_dtype = numpy_dtype(dtype)
    return tuple(
        f if isinstance(f, torch.Tensor) else np.asarray(f, dtype=np_dtype)
        for f in filter_taps(wavelet, flip, dtype)
    )


#: Per-axis hi(1)/lo(0) selection for each 2d output channel: the order
#: ``[ll, lh, hl, hh]`` puts hi-on-the-first-spatial-axis at channel 1
#: (``lh = outer(hi, lo)``), the pywt "horizontal detail".
SUBBAND_ORDERS: dict[int, tuple[tuple[int, ...], ...]] = {
    1: ((0,), (1,)),
    2: ((0, 0), (1, 0), (0, 1), (1, 1)),
    3: (
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
        (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
    ),
}


def construct_nd_filter(lo, hi, ndim: int) -> torch.Tensor:
    """Stack the ``2**ndim`` outer-product filters as ``[2**ndim, 1, *([len] * ndim)]``.

    Channel order follows :data:`SUBBAND_ORDERS`: 1d ``[lo, hi]``; 2d
    ``[ll, lh, hl, hh]`` with ``lh`` = hi along rows (the pywt "horizontal
    detail"); 3d ``[lll ... hhh]`` with the last letter selecting the last
    axis.  Tensors keep their dtype and device (and a gradient path);
    numpy arrays and sequences become tensors of their own dtype.
    """
    lo, hi = torch.as_tensor(lo), torch.as_tensor(hi)
    filters = []
    for selectors in SUBBAND_ORDERS[ndim]:
        filt = lo.new_ones((1,) * ndim)
        for axis, use_hi in enumerate(selectors):
            axis_filt = hi if use_hi else lo
            shape = [1] * ndim
            shape[axis] = axis_filt.shape[0]
            filt = filt * axis_filt.reshape(shape)
        filters.append(filt)
    return torch.stack(filters)[:, None]


def invalid_coeffs_message(kind: str, got) -> str:
    """Shared error text for malformed coefficient containers."""
    return (
        f"Unexpected detail coefficient type: {type(got)}. Detail "
        f"coefficients must be a {kind} as returned by the decomposition."
    )


def infer_periodization(detail_lens: Sequence[int], filt_len: int) -> bool:
    """True when a waverec chain can only come from ``mode="periodization"``.

    Args:
        detail_lens: Per-level detail lengths along one axis, coarse to
            fine (``[len(cD_n), ..., len(cD_1)]``).
        filt_len: Reconstruction filter length.

    The padded-mode analysis recursion ``m = (n + filt_len - 1) // 2``
    strictly exceeds the periodization one ``m = ceil(n / 2)`` whenever
    ``filt_len > 2``, so an exactly-halving chain with at least two
    detail levels is unambiguous evidence of periodization.  Haar chains
    and single-detail chains carry no evidence and return False.
    """
    if filt_len <= 2 or len(detail_lens) < 2:
        return False
    return all(
        coarse == -(-fine // 2)
        for coarse, fine in zip(detail_lens[:-1], detail_lens[1:])
    )


def as_device_tensor(data: Any) -> torch.Tensor:
    """Return ``data`` as a tensor, moving a non-tensor to the card.

    Tensors stay on their own device: the CPU is used only when the caller
    passes a CPU tensor.  Anything else (numpy arrays, lists) goes to
    ``torch.device("cuda")``; without a card this raises.
    """
    if isinstance(data, torch.Tensor):
        return data
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ptwt_tpu_torch computes on the device of its input tensor; a "
            f"{type(data).__name__} input goes to the CUDA device, and none "
            "is available. Pass a CPU tensor to compute on the CPU."
        )
    return torch.as_tensor(np.asarray(data), device=torch.device("cuda"))


def coeffs_from_numpy(coeffs, device: Union[str, torch.device]):
    """Turn a coefficient tree of numpy arrays into the port's containers.

    ``(cA, (H, V, D), ...)`` becomes ``(tensor, WaveletDetailTuple2d, ...)``
    on ``device``; a 1d list ``[cA, cD_n, ...]`` becomes a list of tensors.
    Use it to hand ``ptwt_tpu`` coefficients to ``ptwt_tpu_torch``.
    """

    def _tensor(arr) -> torch.Tensor:
        return torch.tensor(np.asarray(arr), device=device)

    def _detail(item):
        if isinstance(item, tuple):
            return WaveletDetailTuple2d(*(_tensor(v) for v in item))
        return _tensor(item)

    out = [_tensor(coeffs[0])] + [_detail(c) for c in coeffs[1:]]
    return out if isinstance(coeffs, list) else tuple(out)


def coeffs_to_numpy(coeffs):
    """Turn the port's coefficient tree into numpy arrays, keeping the
    containers (the inverse of :func:`coeffs_from_numpy`)."""
    return coeff_tree_map(lambda t: t.detach().cpu().numpy(), coeffs)
