"""Level ops: routing, hand-written CUDA kernels and their plain versions;
the precision of the matrix transforms' products and their long-axis
cutoff."""

from ._boundary_long import long_boundary_cutoff, set_long_boundary_cutoff
from ._conv import get_precision, set_precision
from ._dispatch import analysis_nd, dwt_axis, idwt_axis, synthesis_nd

__all__ = [
    "analysis_nd",
    "dwt_axis",
    "get_precision",
    "idwt_axis",
    "long_boundary_cutoff",
    "set_long_boundary_cutoff",
    "set_precision",
    "synthesis_nd",
]
