"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, one ``nvcc`` per source, all started together,
into ``build/ptwt_tpu_torch_kernels/`` under the checkout; a library's file
name carries a hash of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs when the
module is imported.

Every launch goes through :func:`launch`, which counts it in
:data:`LAUNCHES` and raises if the C entry point reports an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "LAUNCHES",
    "build",
    "check_tensor",
    "launch",
    "reset_launch_counts",
    "static_taps",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "ptwt_tpu_torch_kernels"
_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.POINTER(ctypes.c_double)

#: C entry point -> (source file, argument types).
_ENTRY_POINTS = {
    "ptwt_analysis_axis": (
        "axis", [_I, _P, _P, _D, _D, _I, _LL, _I, _I, _I, _LL, _I, _I, _P]
    ),
    "ptwt_synthesis_axis": (
        "axis",
        [_I, _P, _P, _P, _P, _I, _P, _D, _D, _I, _LL, _I, _I, _LL, _I, _I, _P],
    ),
    "ptwt_analysis_axis_t": (
        "axis_vjp", [_I, _P, _P, _D, _D, _I, _LL, _I, _I, _I, _LL, _I, _I, _P]
    ),
    "ptwt_synthesis_axis_t": (
        "axis_vjp", [_I, _P, _I, _P, _D, _D, _I, _LL, _I, _I, _LL, _I, _I, _P]
    ),
    "ptwt_dwt2": (
        "dwt2", [_I, _P, _P, _D, _D, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    ),
    "ptwt_idwt2": (
        "dwt2",
        [_I, _P, _P, _P, _P, _P, _D, _D, _I, _LL, *[_I] * 11, _P],
    ),
}

#: Launches per kernel since the last :func:`reset_launch_counts`.  A VJP
#: counts under the kernel that runs it: K1 and K2 are each other's VJP,
#: K3T and K4T those of K3 and K4.
LAUNCHES: dict[str, int] = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K3T": 0, "K4T": 0}

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(source: str) -> Path:
    digest = hashlib.sha256()
    for path in (_CSRC / f"{source}.cu", _CSRC / "common.cuh"):
        digest.update(path.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{source}_{digest.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = ("axis", "axis_vjp", "dwt2")) -> dict[str, float]:
    """Compile the given ``csrc`` sources that are not built yet.

    All ``nvcc`` processes start together.  Returns the seconds each build
    took (0.0 for a library already built); raises with the compiler's
    output if one fails.  The compiler's report (registers, spills) is
    kept beside each library as ``.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {s: _library_path(s) for s in sources if not _library_path(s).exists()}
    seconds = {s: 0.0 for s in sources}
    if not todo:
        return seconds
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for source, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{source}.cu")]
        procs[source] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
        )
    failures = []
    for source, (proc, tmp, target) in procs.items():
        output, _ = proc.communicate()
        seconds[source] = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{source}.cu:\n{output}")
            continue
        target.with_suffix(".log").write_text(output)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return seconds


def _library(source: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build((source,))
            lib = ctypes.CDLL(str(_library_path(source)))
            for fn_name, (src, argtypes) in _ENTRY_POINTS.items():
                if src == source:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            lib.ptwt_error_string.argtypes = [ctypes.c_int]
            lib.ptwt_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
        return lib


_NO_FILTER_GRAD = (
    "the CUDA kernels take their filters as constants and give no filter "
    "gradient: learnable wavelets on the card come with their own slice "
    "(ROADMAP Queue 1 item 12). Data gradients do run on the card. Detach "
    "the filters, or use CPU tensors, whose plain path carries filter "
    "gradients."
)


def static_taps(filt) -> list[float]:
    """A filter's taps as python floats for the kernel-parameter bank.

    Raises ``NotImplementedError`` for a filter tensor that autograd would
    have to differentiate.
    """
    if isinstance(filt, torch.Tensor):
        if torch.is_grad_enabled() and filt.requires_grad:
            raise NotImplementedError(_NO_FILTER_GRAD)
        return filt.detach().double().cpu().tolist()
    return [float(v) for v in np.asarray(filt).ravel()]


def taps_array(taps: Sequence[float]):
    """Host copy of a filter's taps as the C entry points take them."""
    return (ctypes.c_double * len(taps))(*taps)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` on ``device``."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype or dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} must be float32 or float64 like the input, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(kernel: str, entry: str, device: torch.device, dtype: torch.dtype, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream.

    ``args`` are the entry point's arguments after the dtype code and
    before the stream; tensors are passed as their data pointers.
    """
    lib = _library(_ENTRY_POINTS[entry][0])
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(_DTYPE_CODE[dtype], *c_args, stream)
    if code != 0:
        raise RuntimeError(
            f"{kernel} ({entry}) failed: {lib.ptwt_error_string(code).decode()}"
        )
    LAUNCHES[kernel] += 1
