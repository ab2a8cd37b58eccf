"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, one ``nvcc`` per source, all started together,
into ``build/ptwt_tpu_torch_kernels/`` under the checkout; a library's file
name carries a hash of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs when the
module is imported.

Every launch goes through :func:`launch`, which counts it in
:data:`LAUNCHES` and raises if the C entry point reports an error.  A
list of tensors among a launch's arguments reaches the C entry point as
an array of device pointers (``None`` as a null pointer).
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
from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter

from ._library import traced

__all__ = [
    "LAUNCHES",
    "build",
    "check_tensor",
    "filters_traced",
    "grad_tracked",
    "host_taps",
    "keep_host_taps",
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
_IA = ctypes.POINTER(ctypes.c_int)
_PA = ctypes.POINTER(ctypes.c_void_p)

#: C entry point -> (source file, argument types).
_ENTRY_POINTS = {
    "ptwt_analysis_axis": (
        "axis", [_I, _P, _P, _D, _D, _I, _LL, _I, _I, _I, _LL, _I, _I, _P]
    ),
    "ptwt_synthesis_axis": (
        "axis",
        [_I, _P, _P, _P, _P, _I, _P, _D, _D, _I, _LL, _I, _I, _LL, _I, _I, _I, _I, _P],
    ),
    # KT: the taps' gradient of a K3/K4 launch
    "ptwt_tap_grad": (
        "axis", [_I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _LL, _I, _I, _I, _LL, _I, _I, _P]
    ),
    "ptwt_dwt2": (
        "dwt2", [_I, _P, _P, _D, _D, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    ),
    "ptwt_idwt2": (
        "dwt2",
        [_I, _P, _P, _P, _P, _P, _D, _D, _I, _LL, *[_I] * 11, _P],
    ),
    "ptwt_fwt1d_analysis": (
        "fwt1d", [_I, _P, _P, _P, _P, _P, _P, _D, _D, _I, _LL, _IA, _I, _I, _P]
    ),
    "ptwt_fwt1d_synthesis": (
        "fwt1d", [_I, _P, _P, _P, _P, _P, _P, _D, _D, _I, _LL, _IA, _I, _I, _P]
    ),
    "ptwt_pyramid2d_analysis": (
        "pyramid2d", [_I, _P, _P, _PA, _D, _D, _I, _LL, _IA, _I, _P]
    ),
    "ptwt_pyramid2d_synthesis": (
        "pyramid2d", [_I, _P, _PA, _P, _D, _D, _I, _LL, _IA, _I, _P]
    ),
    # K9a / K9b take the arguments of ptwt_dwt2 / ptwt_idwt2, then a plan
    "ptwt_mxu2d_analysis": (
        "mxu2d", [_I, _P, _P, _D, _D, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _IA, _I, _P]
    ),
    "ptwt_mxu2d_synthesis": (
        "mxu2d",
        [_I, _P, _P, _P, _P, _P, _D, _D, _I, _LL, *[_I] * 11, _IA, _I, _P],
    ),
}

#: Launches per kernel since the last :func:`reset_launch_counts`.  A VJP
#: counts under the kernel that runs it: K1 and K2 are each other's VJP,
#: and so are K3 and K4 (K3's VJP is K4's fold instance, K4's a
#: zero-bounded K3).  The 1d pyramid kernels of
#: ``csrc/fwt1d.cu`` count under the TPU kernel whose contract a launch
#: carries: a depth-1 launch of the K8 pair is K7a/K7b, and every launch of
#: a K6 pyramid (one per run of at most four levels) is K6a/K6b.  The
#: pyramid pairs are each other's VJP (K5a's VJP launch counts as K5b,
#: K6b's as K6a), and so are the K7/K8 pairs: K8a's VJP is one launch of
#: the synthesis pyramid kernel, counted as K8b (K7a's as K7b), K8b's one
#: launch of the analysis pyramid kernel, counted as K8a.  K9a/K9b (the
#: tensor-core level of ``csrc/mxu2d.cu``, opt-in) take K1/K2's place on
#: the levels their gate admits, their VJPs included: K9a's VJP counts as
#: K9b and K9b's as K9a.  KT (``csrc/axis.cu``, no Pallas counterpart) is
#: the gradient with respect to the filter taps of a K3 or K4 launch.
LAUNCHES: dict[str, int] = {
    name: 0
    for name in (
        "K1", "K2", "K3", "K4", "K5a", "K5b",
        "K6a", "K6b", "K7a", "K7b", "K8a", "K8b", "K9a", "K9b", "KT",
    )
}

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


#: Every ``csrc`` source with kernels.
SOURCES = ("axis", "dwt2", "fwt1d", "mxu2d", "pyramid2d")


def build(sources: Sequence[str] = SOURCES) -> dict[str, float]:
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


def int_array(values: Sequence[int]):
    """Host copy of a launch plan as the C entry points take it."""
    return (ctypes.c_int * len(values))(*values)


_NO_FILTER_GRAD = (
    "this fused kernel takes its filters as constants and gives no filter "
    "gradient. The public transforms route a filter bank that requires "
    "grad, and under torch.compile a bank given as tensors, to the per-axis "
    "kernels K3/K4, whose taps' gradient runs on the card (KT); call them, or "
    "pass constant filters."
)

#: The attribute under which :func:`keep_host_taps` keeps a filter tensor's
#: host copy.
_HOST_TAPS = "_ptwt_host_taps"


def grad_tracked(t) -> bool:
    """Is ``t`` a tensor that autograd or a ``torch.func`` transform
    differentiates?  Inside a nested ``torch.func.grad`` a tensor of an
    outer level reports no ``requires_grad``, but its level tracks it."""
    if not isinstance(t, torch.Tensor):
        return False
    if t.requires_grad:
        return True
    if not torch._C._are_functorch_transforms_active():
        return False
    # Is ``t`` a grad level's wrapper (``is_gradtrackingtensor``)?  Asked as
    # whether one of the levels unwraps it, which dynamo traces too: a vmap
    # level or a tensor no grad level wrapped (a constant bank closed over)
    # unwraps to itself.
    level = retrieve_current_functorch_interpreter().level()
    return any(torch._C._functorch._unwrap_for_grad(t, lvl) is not t for lvl in range(1, level + 1))


def filters_traced(*filts) -> bool:
    """Must the fused routes decline ``filts``?  Where autograd would
    differentiate with respect to one of them, and while dynamo traces a
    bank given as tensors: the fused kernels take their taps as constants
    of the launch, and a trace cannot read a tensor's values.

    The counterpart of the JAX package's ``_is_concrete`` (negated): where
    it holds, every fused route declines and the level runs per axis on
    K3/K4, which take the filters as tensors.
    """
    if torch.compiler.is_dynamo_compiling() and any(isinstance(f, torch.Tensor) for f in filts):
        return True
    return torch.is_grad_enabled() and any(grad_tracked(f) for f in filts)


def keep_host_taps(filts: Sequence[torch.Tensor]) -> None:
    """Read the CUDA filter tensors among ``filts`` to the host in one copy
    and keep each one's taps on it, so that the launches of one transform
    call cost one device sync between them.

    Call it on tensors made for this call only (the taps are not read
    again if the tensor changes in place).  A trace's stand-in (a backward
    formula run by ``torch.compile``'s tracers) holds no taps: the ops read
    theirs when the compiled program runs.
    """
    todo = [
        f for f in filts
        if isinstance(f, torch.Tensor) and f.device.type == "cuda" and not traced(f) and not hasattr(f, _HOST_TAPS)
    ]
    if not todo:
        return
    flat = torch.cat([f.detach().reshape(-1).double() for f in todo]).cpu().tolist()
    start = 0
    for f in todo:
        setattr(f, _HOST_TAPS, flat[start : start + f.numel()])
        start += f.numel()


def host_taps(filt) -> list[float]:
    """A filter's taps as python floats for the kernel-parameter bank (the
    copy :func:`keep_host_taps` kept, or one read now)."""
    if isinstance(filt, torch.Tensor):
        kept = getattr(filt, _HOST_TAPS, None)
        if kept is not None:
            return kept
        return filt.detach().double().cpu().tolist()
    if isinstance(filt, (tuple, list)):  # the transforms' constant banks
        return [float(v) for v in filt]
    return [float(v) for v in np.asarray(filt).ravel()]


def static_taps(filt) -> list[float]:
    """:func:`host_taps` for a fused kernel, whose op takes the taps as
    constants.

    Raises ``NotImplementedError`` for a filter tensor that autograd would
    have to differentiate, or that dynamo traces (:func:`filters_traced`).
    """
    if filters_traced(filt):
        raise NotImplementedError(_NO_FILTER_GRAD)
    return host_taps(filt)


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


def _c_arg(a):
    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    if isinstance(a, list):
        return (ctypes.c_void_p * len(a))(*(None if t is None else t.data_ptr() for t in a))
    return a


def launch(kernel: str, entry: str, device: torch.device, dtype: torch.dtype, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream.

    ``args`` are the entry point's arguments after the dtype code and
    before the stream; tensors are passed as their data pointers, a list
    of tensors as an array of them.
    """
    lib = _library(_ENTRY_POINTS[entry][0])
    c_args = [_c_arg(a) for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(_DTYPE_CODE[dtype], *c_args, stream)
    if code != 0:
        raise RuntimeError(
            f"{kernel} ({entry}) failed: {lib.ptwt_error_string(code).decode()}"
        )
    LAUNCHES[kernel] += 1
