"""Continuous wavelet transform (FFT-domain) with differentiable wavelets.

Counterpart of :mod:`ptwt_tpu.continuous_transform`.  Scales are grouped
by padded FFT size, and each group runs as one data FFT, one FFT of the
stacked wavelet rows and one batched inverse FFT on ``torch.fft`` (cuFFT
on the card), so device time grows sublinearly with the number of scales.
The transform holds no hand-written kernel: the JAX package runs it on
XLA's FFT outside any Pallas kernel, and the per-scale glue around the
FFTs (the gather, flip, pad, crop and scale) is plain torch ops.  Scales
are host values, so each scale's resampled wavelet has a fixed length.

The differentiable wavelets are ``torch.nn.Module``s whose two
sqrt-parametrized ``nn.Parameter``s take gradients through :func:`cwt`.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_map

from .ops._library import constant_tensor
from .ops._matmul import _BytesLRU
from .utils import as_device_tensor
from .wavelets import ContinuousWavelet, DiscreteContinuousWavelet, Wavelet, scale2frequency

__all__ = ["cwt", "ShannonWavelet", "ComplexMorletWavelet", "wavelet_from_numpy"]


def _next_fast_len(n: int) -> int:
    """Next power of two (FFT-friendly size)."""
    return int(2 ** np.ceil(np.log2(n)))


def _integrate_wavelet(wavelet, precision: int):
    """Cumulative integral of the sampled wavelet (rectangle rule).

    Returns ``(int_psi, x)``; for biorthogonal wavelets the decomposition
    psi is used (mirroring pywt's choice of ``psi_d``).  A differentiable
    wavelet gives tensors, a registry wavelet numpy arrays.
    """
    if isinstance(wavelet, str):
        wavelet = DiscreteContinuousWavelet(wavelet)
    functions = wavelet.wavefun(precision)
    if len(functions) == 2:  # continuous
        psi, x = functions
    elif len(functions) == 3:  # orthogonal
        _, psi, x = functions
    else:  # biorthogonal
        _, psi, _, _, x = functions
    step = x[1] - x[0]
    if isinstance(psi, torch.Tensor):
        int_psi = torch.cumsum(psi, -1) * step
    else:
        int_psi = np.cumsum(psi) * step
    return int_psi, x


def _scale_values(scales) -> tuple[float, ...]:
    """The scales as python floats.  They fix the resampled wavelets'
    lengths, so a compiled transform specializes on them: scales given as
    python numbers are constants that ``torch.compile`` guards, and an
    array or tensor of scales is read to the host at a graph break
    (``fullgraph=True`` refuses it, as ``jax.jit`` refuses traced scales).
    """
    if isinstance(scales, (int, float)):
        return (float(scales),)
    if isinstance(scales, (list, tuple, range)) and all(isinstance(v, (int, float)) for v in scales):
        return tuple(float(v) for v in scales)
    return tuple(float(v) for v in np.atleast_1d(np.asarray(scales)).ravel())


def _plan(wavelet, scales: tuple[float, ...], n_time: int, precision: int, device, dtype: torch.dtype):
    """The resampling plan of :func:`cwt` for data of ``dtype`` on
    ``device``: ``(complex_cwt, groups)``, one group per padded FFT size,
    ``(size, rows, entries)``: ``rows`` the scales' flipped resampled
    integrated wavelets zero-padded to ``size`` (``[S_g, size]`` on
    ``device``, complex for a complex wavelet; autograd carries a
    differentiable wavelet's), ``entries`` per row ``(scale index,
    -sqrt(scale), crop start, crop stop)``.

    Raises:
        ValueError: If a scale is too small for the input signal.
    """
    int_psi, x = _integrate_wavelet(wavelet, precision=precision)
    complex_cwt = bool(getattr(wavelet, "complex_cwt", False))
    int_psi = torch.as_tensor(int_psi)
    if complex_cwt:
        int_psi = torch.conj(int_psi)
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    step = x[1] - x[0]
    plans: dict[int, list] = {}
    for si, scale in enumerate(scales):
        j = np.floor(np.arange(scale * (x[-1] - x[0]) + 1) / (scale * step))
        j = j[j < int_psi.shape[0]].astype(int)
        len_s = int(j.shape[0])
        if len_s - 2 < 0 or (n_time + len_s - 2) - n_time < 0:
            raise ValueError(f"Selected scale of {scale} too small.")
        # the center-crop of the n_time + len_s - 2 outputs to n_time
        d = (len_s - 2) / 2.0
        start, stop = int(np.floor(d)), n_time + len_s - 2 - int(np.ceil(d))
        entry = (si, -float(np.sqrt(scale)), start, stop)
        plans.setdefault(_next_fast_len(n_time + len_s - 1), []).append((j[::-1].copy(), entry))
    if complex_cwt:
        dtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    groups = []
    for size, group in plans.items():
        rows = int_psi.new_zeros((len(group), size))
        for gi, (j, _) in enumerate(group):
            rows[gi, : len(j)] = int_psi[torch.as_tensor(j)]
        groups.append((size, rows.to(device=device, dtype=dtype), tuple(entry for _, entry in group)))
    return complex_cwt, tuple(groups)


@torch.compiler.assume_constant_result
def _frequencies(wavelet, scales: tuple[float, ...], precision: int) -> tuple[float, ...]:
    """The scales' normalized frequencies (host work, a constant of a
    compiled transform)."""
    return tuple(float(v) for v in np.atleast_1d(scale2frequency(wavelet, np.asarray(scales), precision)))


#: The named wavelets' plans, capped by their rows' bytes as the operator
#: caches are (a plan's rows are on the data's device).
_PLANS = _BytesLRU(size=lambda plan: sum(rows.nbytes for _, rows, _ in plan[1]))


@torch.compiler.disable  # host work, never traced (also past a graph break)
def _cached_plan(*key):
    name, scales, n_time, precision, device, dtype = key

    def build():
        plan = _plan(DiscreteContinuousWavelet(name), scales, n_time, precision, torch.device(device), dtype)
        return tree_map(constant_tensor, plan)

    return _PLANS.get(key, build)


@torch.compiler.assume_constant_result
def _named_plan(name: str, scales: tuple[float, ...], n_time: int, precision: int, device: str, dtype: torch.dtype):
    """:func:`_plan` of a named wavelet, made once per name, scales,
    length, precision, device and dtype: host work, which
    ``torch.compile`` takes as constants as ``jax.jit`` takes the JAX
    package's plan."""
    return _cached_plan(name, scales, n_time, precision, device, dtype)


def cwt(
    data,
    scales,
    wavelet: Union[ContinuousWavelet, Wavelet, str, "_DifferentiableContinuousWavelet"],
    sampling_period: float = 1.0,
    precision: int = 12,
) -> tuple[torch.Tensor, Union[np.ndarray, torch.Tensor]]:
    """Compute the single-dimensional continuous wavelet transform.

    Args:
        data: Input of shape ``[..., time]``; the last axis is transformed.
            The transform runs on the tensor's device; anything that is not
            a tensor is moved to the CUDA device.
        scales: Wavelet scales (host values; they fix the lengths of the
            resampled wavelets).  Under ``torch.compile`` pass python
            numbers (a tuple, list or range), which it guards: an array or
            tensor of scales is read at a graph break.
        wavelet: Continuous wavelet object or name, or a differentiable
            wavelet module (discrete wavelets are accepted and sampled via
            the cascade, as in pywt).
        sampling_period: Sampling period for the returned frequencies (the
            coefficients themselves are independent of it).
        precision: ``2**precision`` samples are used for the wavelet.

    Returns:
        ``(coeffs, frequencies)`` with ``coeffs`` of shape
        ``[n_scales, ..., time]``.

    Dtype contract: the transform computes in (and returns) the *input's*
    floating precision: ``float32`` data yields ``float32`` (real
    wavelets) or ``complex64`` (complex wavelets) coefficients,
    ``float64`` yields ``float64``/``complex128``.  Integer inputs
    promote to ``torch.get_default_dtype()`` (``ptwt_tpu`` promotes them
    to JAX's default float, float64 under x64).  ``frequencies`` is a
    host-side float64 NumPy array, or for a differentiable wavelet a
    float64 tensor ``center / scales / sampling_period`` on its
    parameters' device that carries their gradient.

    Raises:
        ValueError: If a scale is too small for the input signal.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> t = torch.linspace(-2, 4, 800)
        >>> sig = torch.sin(2 * torch.pi * 7 * t)
        >>> coeffs, freqs = ptwt.cwt(sig, np.arange(1, 31), "mexh")
        >>> tuple(coeffs.shape), int(freqs.shape[0])
        ((30, 800), 30)
    """
    data = as_device_tensor(data)
    if not data.is_floating_point():
        data = data.to(torch.get_default_dtype())
    n_time = data.shape[-1]
    if isinstance(wavelet, str):
        # a named wavelet's samples and plan are constants, made once
        complex_cwt, groups = _named_plan(
            wavelet, _scale_values(scales), n_time, precision, str(data.device), data.dtype
        )
    else:
        if not isinstance(wavelet, (ContinuousWavelet, Wavelet, _DifferentiableContinuousWavelet)):
            wavelet = DiscreteContinuousWavelet(wavelet)
        complex_cwt, groups = _plan(wavelet, _scale_values(scales), n_time, precision, data.device, data.dtype)

    # the scales batched by FFT size: the scales sharing a padded size run
    # as one data FFT, one stacked wavelet FFT and one batched inverse FFT
    out_slots: list = [None] * sum(len(group[2]) for group in groups)
    for size_scale, rows, entries in groups:
        fft_wav = torch.fft.fft(rows, dim=-1)
        # broadcast scales over the data batch: [S_g, ...ones..., size]
        fft_wav = fft_wav.reshape((len(entries),) + (1,) * (data.ndim - 1) + (size_scale,))
        if data.numel():
            conv = torch.fft.ifft(fft_wav * torch.fft.fft(data, n=size_scale, dim=-1)[None], dim=-1)
        else:  # an empty batch: MKL and cuFFT refuse a plan of no transforms
            conv = fft_wav.new_zeros((len(entries), *data.shape[:-1], size_scale))
        diff_full = torch.diff(conv, dim=-1)
        if not complex_cwt:
            diff_full = diff_full.real
        for gi, (si, factor, start, stop) in enumerate(entries):
            # the scaling, and the center-crop to the input length
            out_slots[si] = factor * diff_full[gi, ..., start:stop]

    out = torch.stack(out_slots)
    if isinstance(wavelet, _DifferentiableContinuousWavelet):
        # keep the frequencies differentiable (the center is a parameter)
        center = wavelet.center
        frequencies = center / torch.as_tensor(_scale_values(scales), dtype=center.dtype, device=center.device) / sampling_period
    else:
        frequencies = np.asarray(_frequencies(wavelet, _scale_values(scales), precision)) / sampling_period
    return out, frequencies


class _DifferentiableContinuousWavelet(nn.Module):
    """Base: a continuous wavelet with learnable sqrt-parametrized params.

    ``bandwidth_par`` and ``center_par`` are float64 ``nn.Parameter``s;
    the bandwidth and center are their squares, positive whatever an
    optimizer does to them.  Gradients flow through :func:`cwt` into both.
    """

    def __init__(
        self,
        bandwidth_par,
        center_par,
        lower_bound: float = -8.0,
        upper_bound: float = 8.0,
        complex_cwt: bool = True,
        name: str = "learnable",
    ) -> None:
        super().__init__()
        self.bandwidth_par = nn.Parameter(torch.as_tensor(bandwidth_par, dtype=torch.float64).detach().clone())
        self.center_par = nn.Parameter(torch.as_tensor(center_par, dtype=torch.float64).detach().clone())
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.complex_cwt = complex_cwt
        self.name = name

    @classmethod
    def from_frequencies(cls, bandwidth: float, center: float, **kwargs) -> "_DifferentiableContinuousWavelet":
        """Build from (positive) bandwidth/center frequencies."""
        return cls(
            bandwidth_par=torch.sqrt(torch.as_tensor(bandwidth, dtype=torch.float64)),
            center_par=torch.sqrt(torch.as_tensor(center, dtype=torch.float64)),
            **kwargs,
        )

    @property
    def bandwidth(self) -> torch.Tensor:
        """Squared parameter: guaranteed-positive bandwidth."""
        return self.bandwidth_par * self.bandwidth_par

    @property
    def center(self) -> torch.Tensor:
        """Squared parameter: guaranteed-positive center frequency."""
        return self.center_par * self.center_par

    @property
    def center_frequency(self) -> float:
        """For frequency conversion (host value)."""
        return float(self.center.detach())

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """Evaluate psi on a grid; overridden by concrete wavelets."""
        raise NotImplementedError

    def wavefun(self, precision: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Sample psi on ``2**precision`` grid points (differentiable), on
        the parameters' device."""
        grid = torch.linspace(
            self.lower_bound, self.upper_bound, 2**precision, dtype=torch.float64, device=self.bandwidth_par.device
        )
        return self(grid), grid


class ShannonWavelet(_DifferentiableContinuousWavelet):
    """Differentiable Shannon wavelet ``sqrt(b) sinc(b t) exp(2 pi i c t)``."""

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """Evaluate psi on the grid (``torch.sinc`` is the normalised sinc)."""
        b, c = self.bandwidth, self.center
        return torch.sqrt(b) * torch.sinc(b * grid) * torch.exp(2j * math.pi * c * grid)


class ComplexMorletWavelet(_DifferentiableContinuousWavelet):
    """Differentiable complex Morlet ``(pi b)^-1/2 e^{-t^2/b} e^{2 pi i c t}``."""

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        """Evaluate psi on the grid."""
        b, c = self.bandwidth, self.center
        return 1.0 / torch.sqrt(math.pi * b) * torch.exp(-(grid**2) / b) * torch.exp(2j * math.pi * c * grid)


def wavelet_from_numpy(cls, params: dict, **kwargs) -> _DifferentiableContinuousWavelet:
    """Build a differentiable wavelet module from numpy parameters.

    Args:
        cls: :class:`ShannonWavelet` or :class:`ComplexMorletWavelet`.
        params: ``{"bandwidth_par": array, "center_par": array}``, e.g.
            read off a ``ptwt_tpu`` wavelet of the same family.
        **kwargs: The other fields (``lower_bound``, ``upper_bound``,
            ``complex_cwt``, ``name``).

    Returns:
        The module, its float64 parameters on the CPU (move it with
        ``.to(device)``).
    """
    return cls(
        bandwidth_par=torch.tensor(np.asarray(params["bandwidth_par"], dtype=np.float64)),
        center_par=torch.tensor(np.asarray(params["center_par"], dtype=np.float64)),
        **kwargs,
    )
