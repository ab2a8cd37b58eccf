"""O(n) application of 1d boundary-wavelet operators for long axes.

Counterpart of :mod:`ptwt_tpu.ops._boundary_long`.  A dense ``[n, n]``
boundary operator scales as ``n**2``; but it is *interior-banded*: equal
to the stride-2 (transposed) convolution everywhere except a fixed number
of boundary rows, whose values do not depend on ``n`` once the two
boundaries stop interacting.  So past :func:`long_boundary_cutoff` one
level is applied as

* the interior through the per-axis routing (:func:`._dispatch.dwt_axis_packed`
  in ``valid`` on a zero-padded axis, :func:`._dispatch.idwt_axis_pairs` in
  ``zero`` with the crops ``a`` and ``L - 2 - a``): on a CUDA tensor one
  K3 or one K4 launch, along any axis; plus
* two small dense edge products, whose rows are measured on a small proxy
  operator built by the dense constructor (:mod:`._boundary`), so the
  boundary math (QR or Gram-Schmidt, the ``sameshift`` rows) is the dense
  path's by construction.

The fused runs (:class:`LongAnalysisRun`, :class:`LongSynthesisRun`) take
up to four levels of an exactly halving (doubling) chain on a last axis
longer than ``2**16`` in one launch of the 1d pyramid kernels: K8a's and
K8b's *sameshift* instances (:func:`._pallas1d_multi.sameshift_analysis`,
:func:`._pallas1d_multi.flat_waverec_lane_multi` with the crops ``a``),
which compute every level's pure zero-extended correlation.  Where that
differs from the boundary operator (a cone reaching an edge row), the
run's edge spans are replaced by values computed from head and tail
strips of its inputs.  The JAX package recomputes the strips level by
level in every call; here the strip recursion runs once, on the host in
float64, over unit vectors, and yields each span as one linear map of the
strips: a call applies it as one product per end.  The spans come from
the correlation's reach alone, and the construction asserts, level by
level, that they cover every position where the kernel's zeroed cone
differs from the true band.

Gradients: the per-level ops are autograd-transparent (K3 <-> K4 on the
card, the products' transposes at the same precision).  On the CPU a run
is plain torch ops; on the card it is a custom op (``long_analysis_run``,
``long_synthesis_run``; a run reaches it by the id of :func:`_run_id`)
whose backward is the VJP of the per-level op chain (``torch.func.vjp``),
as in the JAX package (the map is linear).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import _pallas1d_multi as _multi
from ._boundary import boundary_analysis_matrix, boundary_synthesis_matrix, strided_conv_matrix
from ._conv import axis_matmul
from ._dispatch import dwt_axis_packed, idwt_axis_pairs
from ._library import NAMESPACE, autograd, call, constant_tensor, flatten_batch, flatten_list, split_batch, traced
from ..utils._preprocess import constant_taps

__all__ = [
    "LongAnalysisOp",
    "LongAnalysisRun",
    "LongSynthesisOp",
    "LongSynthesisRun",
    "long_boundary_cutoff",
    "long_run_depth",
    "long_supported",
    "long_syn_run_depth",
    "set_long_boundary_cutoff",
]

#: Lengths above this run the O(n) banded apply instead of a dense product.
_LONG_CUTOFF = 2048


def long_boundary_cutoff() -> int:
    """Length above which matrix transforms use the O(n) banded apply."""
    return _LONG_CUTOFF


def set_long_boundary_cutoff(n: int) -> None:
    """Set the dense-operator size cap (mainly for tests and benchmarks)."""
    global _LONG_CUTOFF
    _LONG_CUTOFF = int(n)


def _conv_offset(filt_len: int) -> int:
    """Left offset ``a`` such that interior row ``i`` of the boundary
    operator equals the correlation ``sum_m f[m] x[2i - a + m]`` with the
    flipped filter (``sameshift`` row selection, rows ``1::2``)."""
    start = filt_len // 2 - 1 + filt_len % 2
    return filt_len - 2 - start


def _proxy_length(filt_len: int) -> int:
    """Even proxy size large enough that the two boundaries never interact."""
    n0 = 8 * filt_len
    p = 1
    while p < n0:
        p *= 2
    return max(p, 64)


def _wavelet_key(wavelet):
    """The cache key of a wavelet's edge constructions: its name, or for a
    wavelet object its name and filter values (two banks may share a name)."""
    if isinstance(wavelet, str):
        return wavelet

    def values(f):
        # a list's python floats as they are: no numpy under a trace
        return f if isinstance(f, (list, tuple)) else np.asarray(f, dtype=np.float64).ravel().tolist()

    bank = tuple(tuple(float(v) for v in values(f)) for f in wavelet.filter_bank)
    return getattr(wavelet, "name", None), bank


def _filters(wavelet):
    if isinstance(wavelet, str):
        from ..wavelets import Wavelet

        wavelet = Wavelet(wavelet)
    return tuple(np.asarray(f, dtype=np.float64) for f in wavelet.filter_bank)


@functools.lru_cache(maxsize=128)
def _analysis_edge_structure(key, method: str, phase: int = 0):
    """Measure the analysis edge rows/blocks on a proxy operator.

    Returns ``(dt, ct, db, cb, e_top, e_bot)``: the first ``dt`` rows of
    each branch read only the first ``ct`` samples via ``e_top``
    ``[2*dt, ct]`` (lo rows stacked over hi rows); the last ``db`` rows
    read the last ``cb`` samples via ``e_bot``.

    ``phase`` is ``n % 4`` of the target length: the bottom boundary rows'
    strided alignment (and hence their orthogonalized values) depends on
    whether ``n/2`` is even or odd, so the proxy shares the target's mod-4
    residue.
    """
    wavelet = _KEY_TO_WAVELET[key]
    dec_lo, dec_hi, _, _ = _filters(wavelet)
    filt_len = dec_lo.shape[0]
    n0 = _proxy_length(filt_len) + phase
    a0 = boundary_analysis_matrix(wavelet, n0, method)
    pure = np.concatenate(
        [
            strided_conv_matrix(dec_lo, n0, 2, "sameshift"),
            strided_conv_matrix(dec_hi, n0, 2, "sameshift"),
        ],
        axis=0,
    )
    half = n0 // 2
    diff_rows = np.nonzero(np.abs(a0 - pure).max(axis=1) > 1e-12)[0]
    # rows whose interior correlation would read outside [0, n): the
    # interior zero-pads by ``a`` on each side, so those rows are edge rows
    # too even if the dense operator kept them banded (generous margin)
    a = _conv_offset(filt_len)
    per_branch = [r % half for r in diff_rows]
    dt = max([r + 1 for r in per_branch if r < half // 2] + [a + 2])
    db = max([half - r for r in per_branch if r >= half // 2] + [a + 2])
    rows_top = np.concatenate([np.arange(dt), half + np.arange(dt)])
    rows_bot = np.concatenate([half - db + np.arange(db), n0 - db + np.arange(db)])
    # support threshold: QR leaves ~1e-17 of numerical dust on
    # orthogonalized rows far from the boundary; counting it as support
    # would inflate the edge blocks to the proxy width
    tol = 1e-14
    ct = int(np.max(np.nonzero(np.abs(a0[rows_top]).max(axis=0) > tol)[0])) + 1
    cb = n0 - int(np.min(np.nonzero(np.abs(a0[rows_bot]).max(axis=0) > tol)[0]))
    e_top = a0[rows_top][:, :ct].copy()
    e_bot = a0[rows_bot][:, n0 - cb :].copy()
    # python ints: a compiled transform takes the geometry as constants
    return int(dt), int(ct), int(db), int(cb), e_top, e_bot


@functools.lru_cache(maxsize=128)
def _synthesis_edge_structure(key, method: str, phase: int = 0):
    """Measure the synthesis edge outputs/blocks on a proxy operator.

    Returns ``(st, it, sb, ib, e_top, e_bot)``: output samples ``[0, st)``
    depend only on the first ``it`` coefficients of each branch via
    ``e_top [st, 2*it]``; the last ``sb`` outputs on the last ``ib`` of
    each branch via ``e_bot``.  ``phase`` as in
    :func:`_analysis_edge_structure`.
    """
    wavelet = _KEY_TO_WAVELET[key]
    _, _, rec_lo, rec_hi = _filters(wavelet)
    filt_len = rec_lo.shape[0]
    n0 = _proxy_length(filt_len) + phase
    s0 = boundary_synthesis_matrix(wavelet, n0, method)
    pure = np.concatenate(
        [
            strided_conv_matrix(rec_lo[::-1], n0, 2, "sameshift"),
            strided_conv_matrix(rec_hi[::-1], n0, 2, "sameshift"),
        ],
        axis=0,
    ).T
    half = n0 // 2
    diff_rows = np.nonzero(np.abs(s0 - pure).max(axis=1) > 1e-12)[0]
    a = _conv_offset(filt_len)
    st = max([r + 1 for r in diff_rows if r < half] + [a + 2])
    sb = max([n0 - r for r in diff_rows if r >= half] + [a + 2])
    tol = 1e-14  # see the analysis structure's support threshold
    cols_top = np.nonzero(np.abs(s0[:st]).max(axis=0) > tol)[0]
    it = int(max(c % half for c in cols_top)) + 1
    cols_bot = np.nonzero(np.abs(s0[n0 - sb :]).max(axis=0) > tol)[0]
    ib = half - int(min(c % half for c in cols_bot))
    sel_top = np.concatenate([np.arange(it), half + np.arange(it)])
    sel_bot = np.concatenate([half - ib + np.arange(ib), n0 - ib + np.arange(ib)])
    e_top = s0[:st][:, sel_top].copy()
    e_bot = s0[n0 - sb :][:, sel_bot].copy()
    return int(st), int(it), int(sb), int(ib), e_top, e_bot


#: the proxy construction needs the wavelet object back from its cache key
_KEY_TO_WAVELET: dict = {}


def _register(wavelet):
    key = _wavelet_key(wavelet)
    _KEY_TO_WAVELET.setdefault(key, wavelet)
    return key


def long_supported(wavelet, length: int, method: str = "qr") -> bool:
    """True when the O(n) apply is valid for this (wavelet, length): an
    even length whose two edge blocks do not overlap."""
    if length % 2:
        return False
    key = _register(wavelet)
    phase = length % 4
    _, ct, _, cb, _, _ = _analysis_edge_structure(key, method, phase)
    st, _, sb, _, _, _ = _synthesis_edge_structure(key, method, phase)
    return length >= max(ct + cb, st + sb)


class _Constants:
    """Host operators (float64 numpy) and their tensors, made once per
    device and dtype, so a call makes no host-to-device copy."""

    def __init__(self):
        self._tensors: dict = {}

    def _const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        if not torch.compiler.is_dynamo_compiling() and traced(like):
            # a backward formula run by a torch.compile tracer (the long
            # runs' pullbacks): a constant of its trace, kept nowhere
            return torch.as_tensor(getattr(self, name), dtype=like.dtype, device=like.device)
        key = (name, like.device, like.dtype)
        t = self._tensors.get(key)
        if t is None:
            t = constant_tensor(torch.as_tensor(getattr(self, name), dtype=like.dtype, device=like.device))
            self._tensors[key] = t
        return t


def _neg(axis: int, ndim: int) -> int:
    return axis - ndim if axis >= 0 else axis


def _taps(filt: tuple[float, ...], like: torch.Tensor) -> tuple[float, ...]:
    """A filter's taps at ``like``'s precision, as the routes take them."""
    return constant_taps(filt, False, like.dtype)


class LongAnalysisOp(_Constants):
    """O(n) stand-in for one level's ``[n, n]`` boundary analysis matrix."""

    def __init__(self, wavelet, length: int, method: str = "qr"):
        super().__init__()
        if length % 2:
            raise ValueError("boundary operators require even lengths")
        key = _register(wavelet)
        self.length = length
        dec_lo, dec_hi, _, _ = _filters(wavelet)
        self.filt_len = dec_lo.shape[0]
        # the interior runs the correlation with the flipped filters
        self._f_lo = dec_lo[::-1].copy()
        self._f_hi = dec_hi[::-1].copy()
        self._taps = (tuple(self._f_lo.tolist()), tuple(self._f_hi.tolist()))
        self._dt, self._ct, self._db, self._cb, self._e_top, self._e_bot = _analysis_edge_structure(
            key, method, length % 4
        )
        if length < self._ct + self._cb:
            raise ValueError(f"length {length} too short for the long-boundary apply")

    @property
    def shape(self) -> tuple[int, int]:
        """Shape of the dense operator this object stands in for."""
        return (self.length, self.length)

    def apply(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """``[..., n, ...] -> [..., n, ...]`` packed ``[lo | hi]`` along
        ``axis``."""
        axis = _neg(axis, x.ndim)
        n, half = self.length, self.length // 2
        a = _conv_offset(self.filt_len)
        # zero pad so the valid correlation yields exactly the n/2 rows;
        # rows touching the pad are replaced by the edge products
        pads = [0, 0] * (-axis - 1) + [a, self.filt_len - 2 - a]
        packed = dwt_axis_packed(
            F.pad(x, pads), axis, _taps(self._taps[0], x), _taps(self._taps[1], x), "valid"
        )
        lo, hi = packed.unbind(0)
        top = axis_matmul(x.narrow(axis, 0, self._ct), self._const("_e_top", x), axis)
        bot = axis_matmul(x.narrow(axis, n - self._cb, self._cb), self._const("_e_bot", x), axis)
        dt, db = self._dt, self._db
        return torch.cat(
            [
                top.narrow(axis, 0, dt),
                lo.narrow(axis, dt, half - db - dt),
                bot.narrow(axis, 0, db),
                top.narrow(axis, dt, dt),
                hi.narrow(axis, dt, half - db - dt),
                bot.narrow(axis, db, db),
            ],
            axis,
        )


class LongSynthesisOp(_Constants):
    """O(n) stand-in for one level's ``[n, n]`` boundary synthesis matrix."""

    def __init__(self, wavelet, length: int, method: str = "qr"):
        super().__init__()
        if length % 2:
            raise ValueError("boundary operators require even lengths")
        key = _register(wavelet)
        self.length = length
        _, _, rec_lo, rec_hi = _filters(wavelet)
        self.filt_len = rec_lo.shape[0]
        self._rec_lo = rec_lo
        self._rec_hi = rec_hi
        self._taps = (tuple(rec_lo.tolist()), tuple(rec_hi.tolist()))
        self._st, self._it, self._sb, self._ib, self._e_top, self._e_bot = _synthesis_edge_structure(
            key, method, length % 4
        )
        if length < self._st + self._sb:
            raise ValueError(f"length {length} too short for the long-boundary apply")

    @property
    def shape(self) -> tuple[int, int]:
        """Shape of the dense operator this object stands in for."""
        return (self.length, self.length)

    def apply(self, packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """``[..., 2m, ...]`` packed ``[lo | hi]`` along ``axis`` -> the
        ``[..., n, ...]`` signal."""
        half = self.length // 2
        return self.apply_pair(packed.narrow(axis, 0, half), packed.narrow(axis, half, half), axis)

    def apply_pair(self, lo: torch.Tensor, hi: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """:meth:`apply` on the two halves, with no packing copy."""
        axis = _neg(axis, lo.ndim)
        n = self.length
        a = _conv_offset(self.filt_len)
        # the full transposed convolution has 2(m-1)+L outputs; the
        # operator's rows are its [a, a+n) window
        out = idwt_axis_pairs(
            (lo,), (hi,), axis, _taps(self._taps[0], lo), _taps(self._taps[1], lo),
            a, self.filt_len - 2 - a, "zero",
        )[0]
        it, ib = self._it, self._ib
        top_in = torch.cat([lo.narrow(axis, 0, it), hi.narrow(axis, 0, it)], axis)
        bot_in = torch.cat([lo.narrow(axis, lo.shape[axis] - ib, ib), hi.narrow(axis, hi.shape[axis] - ib, ib)], axis)
        top = axis_matmul(top_in, self._const("_e_top", lo), axis)
        bot = axis_matmul(bot_in, self._const("_e_bot", lo), axis)
        return torch.cat([top, out.narrow(axis, self._st, n - self._st - self._sb), bot], axis)


# ---------------------------------------------------------------------------
# fused runs on K8a/K8b
# ---------------------------------------------------------------------------


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def long_run_depth(wavelet, lengths: Sequence[int], method: str, dtype: torch.dtype) -> int:
    """Depth of the fused analysis run from ``lengths[0]`` (0: none).

    A run fuses consecutive long levels into one K8a launch: the first
    length on a last axis the 1d pyramid kernels take (longer than
    ``2**16``), an exactly halving chain of even lengths, each level
    :func:`long_supported`, depth 2 to 4, and a plan the kernel holds.
    """
    if not lengths or lengths[0] <= _multi.FLAT_MIN_LANES:  # no host work below the kernels' floor
        return 0
    filt_len = _filters(wavelet)[0].shape[0]
    if not _multi._long_lane(lengths[0], filt_len):
        return 0
    depth = 0
    for i, n_l in enumerate(lengths[: _multi.MAX_FUSED_DEPTH]):
        if n_l % 2 or not long_supported(wavelet, n_l, method):
            break
        depth = i + 1
        if i + 1 < len(lengths) and lengths[i + 1] * 2 != n_l:
            break
    a = _conv_offset(filt_len)
    while depth >= 2:
        try:
            _multi._adjoint_plan(filt_len, lengths[0], [n // 2 for n in lengths[:depth]], [a] * depth, _itemsize(dtype))
            break
        except ValueError:
            depth -= 1
    return depth if depth >= 2 else 0


def long_syn_run_depth(wavelet, lengths: Sequence[int], method: str, dtype: torch.dtype) -> int:
    """Depth of the fused synthesis run over the final steps (0: none).

    ``lengths`` are the per-step synthesis sizes, coarse to fine (each
    step maps ``[.., n/2 | n/2]`` to ``[.., n]``).  A run fuses the last
    ``d`` steps into one K8b launch: the finest length on a last axis the
    kernels take, an exactly doubling suffix of even, supported lengths,
    depth 2 to 4, and a plan the kernel holds.
    """
    if not lengths or lengths[-1] <= _multi.FLAT_MIN_LANES:  # no host work below the kernels' floor
        return 0
    filt_len = _filters(wavelet)[0].shape[0]
    if not _multi._long_lane(lengths[-1], filt_len):
        return 0
    a = _conv_offset(filt_len)
    for d in range(min(_multi.MAX_FUSED_DEPTH, len(lengths)), 1, -1):
        suffix = lengths[-d:]
        if any(suffix[i + 1] != 2 * suffix[i] for i in range(d - 1)):
            continue
        if any(s % 2 or not long_supported(wavelet, s, method) for s in suffix):
            continue
        try:
            _multi._syn_plan(filt_len, suffix[-1], [s // 2 for s in suffix[::-1]], [a] * d, _itemsize(dtype))
        except ValueError:
            continue
        return d
    return 0


def _corr(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """``out[:, i] = sum_k f[k] x[:, 2i + k]`` (valid, stride 2)."""
    m = (x.shape[1] - len(f)) // 2 + 1
    out = np.zeros((x.shape[0], max(m, 0)))
    for k, tap in enumerate(f):
        out += tap * x[:, k : k + 2 * m - 1 : 2]
    return out


def _synth(lo: np.ndarray, hi: np.ndarray, f_lo: np.ndarray, f_hi: np.ndarray) -> np.ndarray:
    """The full stride-2 transposed convolution, ``2(m-1) + L`` outputs."""
    m = lo.shape[1]
    out = np.zeros((lo.shape[0], 2 * (m - 1) + len(f_lo)))
    for k in range(len(f_lo)):
        out[:, k : k + 2 * m - 1 : 2] += f_lo[k] * lo + f_hi[k] * hi
    return out


def _check_cover(true: np.ndarray, pure: np.ndarray, span: int, at_end: bool, what: str) -> None:
    """Assert that the kernel's zero-extended values (``pure``) differ from
    the band (``true``) only within the ``span`` stitched positions."""
    differ = np.nonzero(np.abs(true - pure).max(axis=0, initial=0.0) > 1e-9)[0]
    if not differ.size:
        return
    reach = true.shape[1] - int(differ.min()) if at_end else int(differ.max()) + 1
    if reach > span:
        raise AssertionError(f"{what}: the kernel's cone differs from the band {reach} positions in, past the span {span}")


class LongAnalysisRun(_Constants):
    """One K8a launch standing in for ``depth`` levels of
    :class:`LongAnalysisOp` on an exactly halving chain along the last axis.

    Interiors: K8a's sameshift instance.  Spans: the first ``w_l`` and
    last ``w_r`` positions of every band, from one product per end of the
    signal's head and tail strips (:attr:`_head_map`, :attr:`_tail_map`).
    Raises ``ValueError`` for a chain too short for the strips.
    """

    def __init__(self, wavelet, lengths: Sequence[int], method: str = "qr"):
        super().__init__()
        self._key = _register(wavelet)
        self._wavelet = _KEY_TO_WAVELET[self._key]
        self._method = method
        self.lengths = tuple(int(n) for n in lengths)
        self.depth = len(self.lengths)
        if any(n % 2 for n in self.lengths) or any(
            self.lengths[i + 1] * 2 != self.lengths[i] for i in range(self.depth - 1)
        ):
            raise ValueError(f"a fused run needs an exactly halving chain of even lengths, got {self.lengths}")
        dec_lo, dec_hi, _, _ = _filters(wavelet)
        self.filt_len = len(dec_lo)
        self._f_lo = dec_lo[::-1].copy()
        self._f_hi = dec_hi[::-1].copy()
        self._taps = (tuple(self._f_lo.tolist()), tuple(self._f_hi.tolist()))
        self._a = _conv_offset(self.filt_len)
        self._ops = None
        self._geom = [_analysis_edge_structure(self._key, method, n_l % 4) for n_l in self.lengths]
        self._spans = self._edge_spans()
        self._build_maps()

    def _edge_spans(self) -> tuple:
        """Per level ``(half, w_l, w_r)``: positions ``[0, w_l)`` and
        ``[half - w_r, half)`` of band ``l`` differ from the zero-extended
        correlation chain, as an edge row or a cone that reads one."""
        a, L = self._a, self.filt_len
        lv, rv = 0, self.lengths[0] - 1  # the signal itself is exact
        spans = []
        for n_l, (dt, _, db, _, _, _) in zip(self.lengths, self._geom):
            half = n_l // 2
            lv = max(dt, -(-(lv + a) // 2))
            rv = min(half - db - 1, (rv - (L - 1) + a) // 2)
            if lv + (half - 1 - rv) >= half:
                raise ValueError(f"length {n_l} is too short for a fused run")
            spans.append((half, lv, half - 1 - rv))
        return tuple(spans)

    def _strip_lengths(self) -> tuple[int, int]:
        """Head and tail strips of the signal that every level's span and
        edge rows need, from each level's reach back to the signal."""
        a, L = self._a, self.filt_len
        head = tail = 0
        for (_, w_l, w_r), (dt, ct, db, cb, _, _) in zip(self._spans[::-1], self._geom[::-1]):
            head = max(ct, 2 * (max(w_l, dt, head) - 1) + L - a)
            tail = max(cb, 2 * max(w_r, db, tail) + a + 1)
        if max(head, tail) > self.lengths[0]:
            raise ValueError(f"length {self.lengths[0]} is too short for a fused run")
        return head, tail

    def _build_maps(self) -> None:
        """Run the strip recursion of every level on unit vectors (float64)
        and keep each span as a linear map of the strips; assert the spans
        cover the kernel's wrong positions."""
        a, L = self._a, self.filt_len
        s_head, s_tail = self._strip_lengths()
        head = pure_head = np.eye(s_head)
        tail = pure_tail = np.eye(s_tail)
        head_rows, tail_rows = [], []
        for lvl, ((half, w_l, w_r), (dt, ct, db, cb, e_top, e_bot)) in enumerate(
            zip(self._spans, self._geom), start=1
        ):
            n_l = self.lengths[lvl - 1]
            # head strip: edge rows [0, dt), then the strip correlation
            top = head[:, :ct] @ e_top.T
            bands = [_corr(np.pad(h, ((0, 0), (a, 0))), f) for h in (head, pure_head) for f in (self._f_lo, self._f_hi)]
            h_lo, h_hi, p_lo, p_hi = bands
            head_lo = np.concatenate([top[:, :dt], h_lo[:, dt:]], 1)
            head_hi = np.concatenate([top[:, dt:], h_hi[:, dt:]], 1)
            # tail strip, phase aligned: its first sample is 2j - a for a
            # band position j; edge rows [half - db, half) last
            s = tail.shape[1]
            s_t = s - ((n_l - s + a) % 2)
            bot = tail[:, s - cb :] @ e_bot.T
            bands = [
                _corr(np.pad(t[:, s - s_t :], ((0, 0), (0, L - 2 - a))), f)
                for t in (tail, pure_tail) for f in (self._f_lo, self._f_hi)
            ]
            t_lo, t_hi, q_lo, q_hi = bands
            cnt = t_lo.shape[1]
            tail_lo = np.concatenate([t_lo[:, : cnt - db], bot[:, :db]], 1)
            tail_hi = np.concatenate([t_hi[:, : cnt - db], bot[:, db:]], 1)
            for true, pure, span, at_end, band in (
                (head_hi, p_hi, w_l, False, "hi"), (head_lo, p_lo, w_l, False, "lo"),
                (tail_hi, q_hi, w_r, True, "hi"), (tail_lo, q_lo, w_r, True, "lo"),
            ):
                _check_cover(true, pure, span, at_end, f"level {lvl} {band} {'tail' if at_end else 'head'}")
            head_rows.append(head_hi[:, :w_l])
            tail_rows.append(tail_hi[:, cnt - w_r :])
            head, pure_head, tail, pure_tail = head_lo, p_lo, tail_lo, q_lo
        _, w_l, w_r = self._spans[-1]
        head_rows.append(head[:, :w_l])
        tail_rows.append(tail[:, tail.shape[1] - w_r :])
        self._head_map = np.concatenate(head_rows, 1).T  # [sum of w_l, s_head]
        self._tail_map = np.concatenate(tail_rows, 1).T

    def _forward(self, x2: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """``[b, n]`` -> ``(lo_D, [hi_1, ..., hi_D])``: the interiors (K8a's
        sameshift instance, or its plain version) with the spans stitched in."""
        n = self.lengths[0]
        lo_int, his_int = _multi.sameshift_analysis(
            x2, _taps(self._taps[0], x2), _taps(self._taps[1], x2), self._a, self.depth
        )
        head = axis_matmul(x2[:, : self._head_map.shape[1]], self._const("_head_map", x2), -1)
        tail = axis_matmul(x2[:, n - self._tail_map.shape[1] :], self._const("_tail_map", x2), -1)
        # the spans are written over the interiors' ends in place: no copy
        # of the bands (the next level read the interior values already)
        at_h = at_t = 0
        for (half, w_l, w_r), band in zip(self._spans + self._spans[-1:], [*his_int, lo_int]):
            band[:, :w_l] = head[:, at_h : at_h + w_l]
            band[:, half - w_r :] = tail[:, at_t : at_t + w_r]
            at_h += w_l
            at_t += w_r
        return lo_int, his_int

    def _reference(self, x2: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The per-level op chain the run stands in for."""
        if self._ops is None:
            self._ops = [LongAnalysisOp(self._wavelet, n_l, self._method) for n_l in self.lengths]
        cur, his = x2, []
        for op in self._ops:
            lo, hi = op.apply(cur).chunk(2, -1)
            cur = lo
            his.append(hi)
        return cur, his

    def apply(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """``[..., n]`` -> ``(lo_D [..., n/2^D], [hi_1, ..., hi_D])``."""
        lead = x.shape[:-1]
        x2 = x.reshape(math.prod(lead), self.lengths[0])
        if _multi._on_cpu(x2):
            lo, his = self._forward(x2)
        else:
            lo, *his = call(long_analysis_run, x2.contiguous(), _run_id(self))
        return lo.reshape(*lead, lo.shape[-1]), [h.reshape(*lead, h.shape[-1]) for h in his]


class LongSynthesisRun(_Constants):
    """One K8b launch standing in for ``depth`` steps of
    :class:`LongSynthesisOp` on an exactly doubling chain along the last axis.

    Interior: K8b's sameshift instance (every step's crop ``a``).  Spans:
    the first ``w_l`` and last ``w_r`` outputs, from one product per end of
    the coefficients' head and tail strips.  Raises ``ValueError`` for a
    chain too short for the strips.
    """

    def __init__(self, wavelet, lengths: Sequence[int], method: str = "qr"):
        super().__init__()
        self._key = _register(wavelet)
        self._wavelet = _KEY_TO_WAVELET[self._key]
        self._method = method
        self.lengths = tuple(int(n) for n in lengths)  # coarse -> fine
        self.depth = len(self.lengths)
        if any(n % 2 for n in self.lengths) or any(
            self.lengths[i + 1] != 2 * self.lengths[i] for i in range(self.depth - 1)
        ):
            raise ValueError(f"a fused run needs an exactly doubling chain of even lengths, got {self.lengths}")
        _, _, rec_lo, rec_hi = _filters(wavelet)
        self.filt_len = len(rec_lo)
        self._rec_lo = rec_lo
        self._rec_hi = rec_hi
        self._taps = (tuple(rec_lo.tolist()), tuple(rec_hi.tolist()))
        self._a = _conv_offset(self.filt_len)
        self._ops = None
        self._geom = [_synthesis_edge_structure(self._key, method, n_l % 4) for n_l in self.lengths]
        self._spans = self._edge_spans()
        self._build_maps()

    def _edge_spans(self) -> list:
        """Per step ``(w_l, w_r)``: outputs ``[0, w_l)`` and ``[n - w_r, n)``
        differ from the zero-extended chain, as an edge row or one whose
        taps read a wrong coefficient."""
        a, L = self._a, self.filt_len
        lv, rv = 0, self.lengths[0] // 2 - 1  # the coefficients are exact
        spans = []
        for (st, _, sb, _, _, _), n_j in zip(self._geom, self.lengths):
            lv = max(st, 2 * lv + L - 1 - a)
            rv = min(n_j - sb - 1, 2 * rv - a + 1)
            spans.append((lv, n_j - 1 - rv))
        if sum(spans[-1]) >= self.lengths[-1]:
            raise ValueError(f"length {self.lengths[-1]} is too short for a fused synthesis run")
        return spans

    def _strip_lengths(self) -> tuple[list[int], list[int]]:
        """Head and tail strips of each step's input band (coarse to fine)
        that the final spans and every step's edge rows need."""
        a, L = self._a, self.filt_len
        w_l, w_r = self._spans[-1]
        heads, tails = [], []
        need_h, need_t = w_l, w_r
        for (st, it, sb, ib, _, _), n_j in zip(self._geom[::-1], self.lengths[::-1]):
            need_h = max(it, -(-(max(need_h, st) + 1 + a) // 2))
            need_t = max(ib, -(-(max(need_t, sb) + L - a) // 2))
            heads.append(need_h)
            tails.append(need_t)
        heads, tails = heads[::-1], tails[::-1]
        # the strips grow by the recursion from the coarsest one
        for j in range(1, self.depth):
            heads[j] = 2 * heads[j - 1] - 1 - a
            tails[j] = 2 * tails[j - 1] + a - L
        if any(max(h, t) > n_j // 2 for h, t, n_j in zip(heads, tails, self.lengths)):
            raise ValueError(f"length {self.lengths[-1]} is too short for a fused synthesis run")
        return heads, tails

    def _build_maps(self) -> None:
        """Run the strip recursion on unit vectors (float64) over the
        concatenated strips ``[lo_D, hi_D, ..., hi_1]`` of each end and keep
        the final spans as linear maps; assert, step by step, that the
        spans cover the kernel's wrong positions."""
        a, L = self._a, self.filt_len
        heads, tails = self._strip_lengths()
        self._heads, self._tails = heads, tails
        for end, lengths in (("head", heads), ("tail", tails)):
            cols = np.eye(lengths[0] + sum(lengths))
            cur = pure = cols[:, : lengths[0]]
            at = lengths[0]
            for j, ((st, it, sb, ib, e_top, e_bot), n_j) in enumerate(zip(self._geom, self.lengths)):
                hi = cols[:, at : at + lengths[j]]
                at += lengths[j]
                s = cur.shape[1]
                full, full_p = _synth(cur, hi, self._rec_lo, self._rec_hi), _synth(pure, hi, self._rec_lo, self._rec_hi)
                if end == "head":
                    top = np.concatenate([cur[:, :it], hi[:, :it]], 1) @ e_top.T
                    cur = np.concatenate([top, full[:, a + st : 2 * s - 1]], 1)
                    pure = full_p[:, a : 2 * s - 1]
                else:
                    bot = np.concatenate([cur[:, s - ib :], hi[:, s - ib :]], 1) @ e_bot.T
                    out = full[:, L : 2 * s + a]
                    cur = np.concatenate([out[:, : out.shape[1] - sb], bot], 1)
                    pure = full_p[:, L : 2 * s + a]
                span = self._spans[j][0 if end == "head" else 1]
                _check_cover(cur, pure, span, end == "tail", f"step {j + 1} {end}")
            w = self._spans[-1][0 if end == "head" else 1]
            rows = cur[:, :w] if end == "head" else cur[:, cur.shape[1] - w :]
            setattr(self, f"_{end}_map", rows.T.copy())

    def _forward(self, lo2: torch.Tensor, his2: Sequence[torch.Tensor]) -> torch.Tensor:
        """``[b, m_1]`` + his (coarse to fine) -> ``[b, n_fine]``: the
        interior (K8b's sameshift instance, or its plain version) with the
        spans stitched in."""
        n = self.lengths[-1]
        interior = _multi.flat_waverec_lane_multi(
            [lo2, *his2], _taps(self._taps[0], lo2), _taps(self._taps[1], lo2),
            (self._a,) * self.depth, self.lengths[::-1],
        )
        bands = [lo2, *his2]
        head_in = torch.cat([b[:, :s] for b, s in zip(bands, [self._heads[0], *self._heads])], -1)
        tail_in = torch.cat([b[:, b.shape[-1] - s :] for b, s in zip(bands, [self._tails[0], *self._tails])], -1)
        head = axis_matmul(head_in, self._const("_head_map", lo2), -1)
        tail = axis_matmul(tail_in, self._const("_tail_map", lo2), -1)
        w_l, w_r = self._spans[-1]
        interior[:, :w_l] = head
        interior[:, n - w_r :] = tail
        return interior

    def _reference(self, lo2: torch.Tensor, his2: Sequence[torch.Tensor]) -> torch.Tensor:
        """The per-step op chain the run stands in for."""
        if self._ops is None:
            self._ops = [LongSynthesisOp(self._wavelet, n_j, self._method) for n_j in self.lengths]
        cur = lo2
        for op, hi in zip(self._ops, his2):
            cur = op.apply_pair(cur, hi)
        return cur

    def apply(self, lo: torch.Tensor, his: Sequence[torch.Tensor]) -> torch.Tensor:
        """``[..., m_1]`` + his (coarse to fine) -> ``[..., n_fine]``."""
        lead = lo.shape[:-1]
        rows = math.prod(lead)
        lo2 = lo.reshape(rows, lo.shape[-1])
        his2 = [h.reshape(rows, h.shape[-1]) for h in his]
        if _multi._on_cpu(lo2):
            out = self._forward(lo2, his2)
        else:
            out = call(long_synthesis_run, [b.contiguous() for b in (lo2, *his2)], _run_id(self))
        return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# the fused runs as custom ops
# ---------------------------------------------------------------------------

#: Every fused run an op has named, by its id (the ops take the id: a run
#: is no argument type of an op).  One run per wavelet, chain and method.
_RUNS: list = []
_RUN_IDS: dict = {}


def _run_id(run) -> int:
    """The id under which the ops find ``run`` (or an equal one)."""
    key = (type(run).__name__, run._key, run.lengths, run._method)
    run_id = _RUN_IDS.get(key)
    if run_id is None:
        run_id = _RUN_IDS[key] = len(_RUNS)
        _RUNS.append(run)
    return run_id


@torch.library.custom_op(f"{NAMESPACE}::long_analysis_run", mutates_args=())
def long_analysis_run(x2: torch.Tensor, run: int) -> list[torch.Tensor]:
    """A fused analysis run on ``[rows, n]`` (one launch of K8a's sameshift
    instance and the spans' products): ``[lo_D, hi_1, ..., hi_D]``."""
    lo, his = _RUNS[run]._forward(x2)
    return [lo, *his]


@long_analysis_run.register_fake
def _(x2, run):
    lengths = _RUNS[run].lengths
    rows = x2.shape[0]
    return [x2.new_empty(rows, lengths[-1] // 2)] + [x2.new_empty(rows, n // 2) for n in lengths]


def _long_analysis_setup(ctx, inputs, output):
    ctx.shape, ctx.run = tuple(inputs[0].shape), inputs[1]


def _long_analysis_backward(ctx, cts):
    """The VJP of the per-level op chain the run stands in for (K3 <-> K4
    and the edge products' transposes); the map is linear."""
    lo_ct, *his_cts = cts
    _, pullback = torch.func.vjp(_RUNS[ctx.run]._reference, lo_ct.new_zeros(ctx.shape))
    (grad,) = pullback((lo_ct, his_cts))
    return grad, None


@long_analysis_run.register_vmap
def _(info, in_dims, x2, run):
    size = info.batch_size
    outs = long_analysis_run(flatten_batch(x2, in_dims[0], size), run)
    return [split_batch(t, size) for t in outs], [0] * len(outs)


@torch.library.custom_op(f"{NAMESPACE}::long_synthesis_run", mutates_args=())
def long_synthesis_run(bands: list[torch.Tensor], run: int) -> torch.Tensor:
    """A fused synthesis run on ``[lo, hi_1, ..., hi_D]`` (coarse to fine,
    each ``[rows, m]``; one launch of K8b's sameshift instance and the
    spans' products) -> ``[rows, n_fine]``."""
    return _RUNS[run]._forward(bands[0], bands[1:])


@long_synthesis_run.register_fake
def _(bands, run):
    return bands[0].new_empty(bands[0].shape[0], _RUNS[run].lengths[-1])


def _long_synthesis_setup(ctx, inputs, output):
    ctx.shapes, ctx.run = [tuple(b.shape) for b in inputs[0]], inputs[1]


def _long_synthesis_backward(ctx, ct):
    """The VJP of the per-step op chain the run stands in for."""
    zeros = [ct.new_zeros(shape) for shape in ctx.shapes]
    _, pullback = torch.func.vjp(_RUNS[ctx.run]._reference, zeros[0], zeros[1:])
    lo_grad, his_grads = pullback(ct)
    return [lo_grad, *his_grads], None


@long_synthesis_run.register_vmap
def _(info, in_dims, bands, run):
    size = info.batch_size
    return split_batch(long_synthesis_run(flatten_list(bands, in_dims[0], size), run), size), 0


autograd(long_analysis_run, _long_analysis_setup, _long_analysis_backward)
autograd(long_synthesis_run, _long_synthesis_setup, _long_synthesis_backward)
