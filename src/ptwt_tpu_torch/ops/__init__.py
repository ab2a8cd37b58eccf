"""Level ops: routing, hand-written CUDA kernels and their plain versions."""

from ._dispatch import analysis_nd, dwt_axis, idwt_axis, synthesis_nd

__all__ = ["analysis_nd", "dwt_axis", "idwt_axis", "synthesis_nd"]
