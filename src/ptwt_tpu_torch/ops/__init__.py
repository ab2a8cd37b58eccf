"""Level ops: routing, hand-written CUDA kernels and their plain versions;
the dense operators and filter-bank convolutions; the precision of the
dense products and their axis-length cutoff; the long-boundary cutoff of
the matrix transforms.

Counterpart of :mod:`ptwt_tpu.ops`, whose public names it carries in
their order.
"""

from ._conv import (
    analysis_conv,
    get_precision,
    periodization_wrap,
    set_precision,
    synthesis_conv,
)
from ._boundary_long import long_boundary_cutoff, set_long_boundary_cutoff
from ._dispatch import analysis_nd, dwt_axis, idwt_axis, synthesis_nd
from ._matmul import (
    analysis_matrix,
    get_matmul_max_length,
    set_matmul_max_length,
    synthesis_matrix,
)

__all__ = [
    "analysis_conv",
    "synthesis_conv",
    "analysis_nd",
    "synthesis_nd",
    "dwt_axis",
    "idwt_axis",
    "analysis_matrix",
    "synthesis_matrix",
    "periodization_wrap",
    "set_precision",
    "get_precision",
    "set_matmul_max_length",
    "get_matmul_max_length",
    "long_boundary_cutoff",
    "set_long_boundary_cutoff",
]
