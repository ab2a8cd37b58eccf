"""Multi-device distributed wavelet transforms (mesh + halo exchange).

Counterpart of :mod:`ptwt_tpu.parallel`, on ``torch.distributed``: a named
:class:`~torch.distributed.device_mesh.DeviceMesh`, each process running
its own chunk through the port's kernels, ring halo exchanges as
functional collectives (``all_to_all_single``, one per exchange) where the
JAX package uses ``lax.ppermute``, and ``DTensor`` coefficients whose
``full_tensor()`` is the subband gather.  Every entry point also runs
under ``torch.compile(fullgraph=True)``, as the JAX package's run under
``jax.jit``.  Run one process per rank (``torchrun``) after
``torch.distributed.init_process_group``.  NCCL carries CUDA tensors; with
gloo the halo slabs of CUDA tensors go through host memory.
"""

from .tiled2d import make_wavelet_mesh, tiled_wavedec2, tiled_waverec2
from .tiledn import (
    tiled_wavedec,
    tiled_wavedec3,
    tiled_waverec,
    tiled_waverec3,
)

__all__ = [
    "make_wavelet_mesh",
    "tiled_wavedec",
    "tiled_waverec",
    "tiled_wavedec2",
    "tiled_waverec2",
    "tiled_wavedec3",
    "tiled_waverec3",
]
