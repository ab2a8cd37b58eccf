"""PyTorch and CUDA port of the ptwt-tpu wavelet toolbox.

The 1d, 2d and 3d fast wavelet transforms (``wavedec``/``waverec``,
``wavedec2``/``waverec2``, ``wavedec3``/``waverec3``), the fully
separable 2d and 3d transforms (``fswavedec2``/``fswaverec2``,
``fswavedec3``/``fswaverec3``), the stationary transform (``swt``/
``iswt``) and the boundary-wavelet matrix transforms (``MatrixWavedec``/
``MatrixWaverec`` in 1d, 2d and 3d) run on the device of their input: on
an NVIDIA H100 through hand-written CUDA kernels (built from ``csrc/`` at
first use) and, for the matrix transforms' dense operators, full-float32
matrix products; on the CPU through their plain torch versions.
Non-tensor inputs go to the CUDA device.  Still to come from the JAX
package's list: the wavelet packets (``WaveletPacket``,
``WaveletPacket2D``), the continuous transform (``cwt``) and the
continuous-wavelet helpers (``ShannonWavelet``, ``ComplexMorletWavelet``,
``ContinuousWavelet``, ``DiscreteContinuousWavelet``,
``central_frequency``, ``scale2frequency``).  This package imports
``torch``, numpy and scipy, and nothing of JAX or of ``ptwt_tpu``.
"""

from .constants import (
    Wavelet,
    WaveletCoeff1d,
    WaveletCoeff2d,
    WaveletCoeff2dSeparable,
    WaveletCoeffNd,
    WaveletDetailDict,
    WaveletDetailTuple2d,
    WaveletTensorTuple,
)
from .conv_transform import wavedec, waverec
from .conv_transform_2 import wavedec2, waverec2
from .conv_transform_3 import wavedec3, waverec3
from .matmul_transform import MatrixWavedec, MatrixWaverec
from .matmul_transform_2 import MatrixWavedec2, MatrixWaverec2
from .matmul_transform_3 import MatrixWavedec3, MatrixWaverec3
from .separable_conv_transform import fswavedec2, fswavedec3, fswaverec2, fswaverec3
from .stationary_transform import iswt, swt
from .version import VERSION, get_version
from .wavelets import Wavelet as RegistryWavelet
from .wavelets import dwt_max_level, dwtn_max_level, swt_max_level, wavelist

__all__ = [
    "MatrixWavedec",
    "MatrixWavedec2",
    "MatrixWavedec3",
    "MatrixWaverec",
    "MatrixWaverec2",
    "MatrixWaverec3",
    "VERSION",
    "RegistryWavelet",
    "Wavelet",
    "WaveletCoeff1d",
    "WaveletCoeff2d",
    "WaveletCoeff2dSeparable",
    "WaveletCoeffNd",
    "WaveletDetailDict",
    "WaveletDetailTuple2d",
    "WaveletTensorTuple",
    "dwt_max_level",
    "dwtn_max_level",
    "fswavedec2",
    "fswavedec3",
    "fswaverec2",
    "fswaverec3",
    "get_version",
    "iswt",
    "swt",
    "swt_max_level",
    "wavedec",
    "wavedec2",
    "wavedec3",
    "waverec",
    "waverec2",
    "waverec3",
    "wavelist",
]
