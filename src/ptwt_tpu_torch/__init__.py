"""PyTorch and CUDA port of the ptwt-tpu wavelet toolbox.

The 1d and 2d fast wavelet transforms (``wavedec``/``waverec``,
``wavedec2``/``waverec2``) run on the device of their input: on an NVIDIA
H100 through hand-written CUDA kernels (built from ``csrc/`` at first
use), on the CPU through their plain torch versions.  Non-tensor inputs go to the CUDA device.  This package imports
``torch``, numpy and scipy, and nothing of JAX or of ``ptwt_tpu``.
"""

from .constants import (
    Wavelet,
    WaveletCoeff1d,
    WaveletCoeff2d,
    WaveletDetailTuple2d,
    WaveletTensorTuple,
)
from .conv_transform import wavedec, waverec
from .conv_transform_2 import wavedec2, waverec2
from .version import VERSION, get_version
from .wavelets import Wavelet as RegistryWavelet
from .wavelets import dwt_max_level, wavelist

__all__ = [
    "VERSION",
    "RegistryWavelet",
    "Wavelet",
    "WaveletCoeff1d",
    "WaveletCoeff2d",
    "WaveletDetailTuple2d",
    "WaveletTensorTuple",
    "dwt_max_level",
    "get_version",
    "wavedec",
    "wavedec2",
    "waverec",
    "waverec2",
    "wavelist",
]
