"""Shared utilities: padding, axes/batch preprocessing, filter arrays."""

from ._deprecation import deprecated_alias
from ._padding import fwt_pad, get_pad, translate_mode
from ._preprocess import (
    SUBBAND_ORDERS,
    as_device_tensor,
    check_axes_argument,
    coeff_tree_map,
    coeffs_from_numpy,
    coeffs_to_numpy,
    get_filter_arrays,
    infer_periodization,
    postprocess_coeffs,
    postprocess_tensor,
    preprocess_coeffs,
    preprocess_tensor,
    swap_axes,
    undo_swap_axes,
)

__all__ = [
    "deprecated_alias",
    "fwt_pad",
    "get_pad",
    "translate_mode",
    "SUBBAND_ORDERS",
    "as_device_tensor",
    "check_axes_argument",
    "coeff_tree_map",
    "coeffs_from_numpy",
    "coeffs_to_numpy",
    "get_filter_arrays",
    "infer_periodization",
    "postprocess_coeffs",
    "postprocess_tensor",
    "preprocess_coeffs",
    "preprocess_tensor",
    "swap_axes",
    "undo_swap_axes",
]
