"""PyTorch and CUDA port of the ptwt-tpu wavelet toolbox.

The 1d, 2d and 3d fast wavelet transforms (``wavedec``/``waverec``,
``wavedec2``/``waverec2``, ``wavedec3``/``waverec3``), the fully
separable 2d and 3d transforms (``fswavedec2``/``fswaverec2``,
``fswavedec3``/``fswaverec3``), the stationary transform (``swt``/
``iswt``), the boundary-wavelet matrix transforms (``MatrixWavedec``/
``MatrixWaverec`` in 1d, 2d and 3d), the wavelet packet trees
(``WaveletPacket``, ``WaveletPacket2D``) and the continuous transform
(``cwt``, with the differentiable ``ShannonWavelet`` and
``ComplexMorletWavelet`` modules) run on the device of their input: on
an NVIDIA H100 through hand-written CUDA kernels (built from ``csrc/`` at
first use), for the matrix transforms' dense operators full-float32
matrix products, and for ``cwt`` cuFFT through ``torch.fft``; on the CPU
through their plain torch versions.  Non-tensor inputs go to the CUDA
device.  This package imports ``torch``, numpy and scipy, and nothing of
JAX or of ``ptwt_tpu``.
"""

from .constants import (
    Wavelet,
    WaveletCoeff1d,  # noqa: F401  (a container alias, not in __all__ as in ptwt_tpu)
    WaveletCoeff2d,
    WaveletCoeff2dSeparable,
    WaveletCoeffNd,
    WaveletDetailDict,
    WaveletDetailTuple2d,
    WaveletTensorTuple,
)
from .continuous_transform import ComplexMorletWavelet, ShannonWavelet, cwt
from .conv_transform import wavedec, waverec
from .conv_transform_2 import wavedec2, waverec2
from .conv_transform_3 import wavedec3, waverec3
from .matmul_transform import MatrixWavedec, MatrixWaverec
from .matmul_transform_2 import MatrixWavedec2, MatrixWaverec2
from .matmul_transform_3 import MatrixWavedec3, MatrixWaverec3
from .packets import WaveletPacket, WaveletPacket2D
from .separable_conv_transform import fswavedec2, fswavedec3, fswaverec2, fswaverec3
from .stationary_transform import iswt, swt
from .version import VERSION, get_version
from .wavelets import (
    ContinuousWavelet,
    DiscreteContinuousWavelet,
    central_frequency,
    dwt_max_level,
    dwtn_max_level,
    scale2frequency,
    swt_max_level,
    wavelist,
)
from .wavelets import Wavelet as RegistryWavelet

__all__ = [
    "Wavelet",
    "WaveletTensorTuple",
    "WaveletDetailTuple2d",
    "WaveletCoeff2d",
    "WaveletCoeff2dSeparable",
    "WaveletCoeffNd",
    "WaveletDetailDict",
    "VERSION",
    "get_version",
    "wavedec",
    "waverec",
    "wavedec2",
    "waverec2",
    "wavedec3",
    "waverec3",
    "fswavedec2",
    "fswavedec3",
    "fswaverec2",
    "fswaverec3",
    "swt",
    "iswt",
    "cwt",
    "MatrixWavedec",
    "MatrixWaverec",
    "MatrixWavedec2",
    "MatrixWaverec2",
    "MatrixWavedec3",
    "MatrixWaverec3",
    "WaveletPacket",
    "WaveletPacket2D",
    "ShannonWavelet",
    "ComplexMorletWavelet",
    "RegistryWavelet",
    "ContinuousWavelet",
    "DiscreteContinuousWavelet",
    "wavelist",
    "dwt_max_level",
    "dwtn_max_level",
    "swt_max_level",
    "central_frequency",
    "scale2frequency",
]
