"""Shared utilities: padding, axes/batch preprocessing, filter arrays and
construction, coefficient containers."""

from ._deprecation import deprecated_alias
from ._padding import fwt_pad, get_pad, translate_mode
from ._preprocess import (
    SUBBAND_ORDERS,
    as_device_tensor,
    check_axes_argument,
    coeff_tree_map,
    coeffs_from_numpy,
    coeffs_to_numpy,
    construct_nd_filter,
    filter_taps,
    get_filter_arrays,
    infer_periodization,
    invalid_coeffs_message,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
    swap_axes,
    undo_swap_axes,
)

# the JAX package's names in its order, then the port's own
__all__ = [
    "deprecated_alias",
    "fwt_pad",
    "get_pad",
    "translate_mode",
    "preprocess_tensor",
    "postprocess_tensor",
    "preprocess_coeffs",
    "postprocess_coeffs",
    "coeff_tree_map",
    "get_filter_arrays",
    "infer_periodization",
    "construct_nd_filter",
    "swap_axes",
    "undo_swap_axes",
    "check_axes_argument",
    "invalid_coeffs_message",
    "SUBBAND_ORDERS",
    "as_device_tensor",
    "coeffs_from_numpy",
    "coeffs_to_numpy",
]
