"""PyTorch and CUDA port of the ptwt-tpu wavelet toolbox.

The 1d, 2d and 3d fast wavelet transforms (``wavedec``/``waverec``,
``wavedec2``/``waverec2``, ``wavedec3``/``waverec3``) and the fully
separable 2d and 3d transforms (``fswavedec2``/``fswaverec2``,
``fswavedec3``/``fswaverec3``) run on the device of their input: on an
NVIDIA H100 through hand-written CUDA kernels (built from ``csrc/`` at
first use), on the CPU through their plain torch versions.  Non-tensor
inputs go to the CUDA device.  This package imports ``torch``, numpy and
scipy, and nothing of JAX or of ``ptwt_tpu``.
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
from .separable_conv_transform import fswavedec2, fswavedec3, fswaverec2, fswaverec3
from .version import VERSION, get_version
from .wavelets import Wavelet as RegistryWavelet
from .wavelets import dwt_max_level, dwtn_max_level, wavelist

__all__ = [
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
    "wavedec",
    "wavedec2",
    "wavedec3",
    "waverec",
    "waverec2",
    "waverec3",
    "wavelist",
]
