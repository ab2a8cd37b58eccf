"""Lazily expanded 1d/2d wavelet packet trees.

Counterpart of :mod:`ptwt_tpu.packets`: host-side dict bookkeeping over
level-1 calls of the port's transforms, so each node runs on its parent's
device through the routes those transforms take (the hand-written kernels
on the card, their plain versions on the CPU).  Three interchangeable
backends per node: padded convolution (``wavedec``/``wavedec2``), fully
separable convolution (2d, ``fswavedec2``) and the boundary-wavelet matrix
transforms (cached per node shape).  Node orderings (natural and Gray-code
frequency order) follow the pywt conventions.

Both tree classes share one engine (:class:`_LazyPacketTree`): a dict from
node path to coefficient tensor, where reading an absent path triggers a
single level-1 analysis of its parent, and :meth:`reconstruct` runs one
level-1 synthesis per node, deepest level first, overwriting each parent
from its children.

Backend-consistency note: every backend here labels the 2d subbands
identically (``h`` = high-pass on rows, matching :func:`wavedec2` and
pywt's ``dwt2``), as ``ptwt_tpu`` does; upstream ptwt's separable backend
swaps ``h``/``v`` relative to its own convolution backend.
"""

from __future__ import annotations

import collections
from functools import partial
from itertools import product
from typing import Iterable, Optional, Union

import torch

from .constants import (
    ExtendedBoundaryMode,
    OrthogonalizeMethod,
    PacketNodeOrder,
    Wavelet,
    WaveletDetailTuple2d,
)
from .conv_transform import wavedec, waverec
from .conv_transform_2 import wavedec2, waverec2
from .matmul_transform import MatrixWavedec, MatrixWaverec
from .matmul_transform_2 import MatrixWavedec2, MatrixWaverec2
from .separable_conv_transform import fswavedec2, fswaverec2
from .utils import as_device_tensor, deprecated_alias
from .wavelets import Wavelet as RegistryWavelet
from .wavelets import dwt_max_level

__all__ = ["WaveletPacket", "WaveletPacket2D", "get_freq_order"]


def _as_wavelet(wavelet) -> Wavelet:
    return RegistryWavelet(wavelet) if isinstance(wavelet, str) else wavelet


def _wpfreq(fs: float, level: int) -> list[float]:
    """Frequency bins of a fully decomposed 1d packet tree (freq order)."""
    n_nodes = 2**level
    return [(fs / 2.0) * (k / n_nodes) for k in range(n_nodes)]


def _graycode_order(level: int, x: str = "a", y: str = "d") -> list[str]:
    """Binary-reflected Gray-code paths of depth ``level``, MSB first.

    Path ``k`` spells out the bits of ``k ^ (k >> 1)`` with ``x`` for 0 and
    ``y`` for 1: the frequency ordering of a fully decomposed packet tree.
    """
    return [
        "".join((x, y)[(k ^ (k >> 1)) >> (level - 1 - pos) & 1] for pos in range(level))
        for k in range(2**level)
    ]


class _LazyPacketTree(collections.UserDict):
    """Dict of node path -> coefficients with on-demand level-1 expansion.

    Subclasses define the alphabet (``_filter_keys``, deterministic order),
    the transformed axes, and the two single-level hooks ``_split_into``
    (parent tensor -> child entries) and ``_merge_children`` (child tensors
    -> parent tensor).  Everything else (lazy reads, bulk initialization,
    and bottom-up reconstruction with odd-length crop handling) lives here.
    """

    _filter_keys: tuple[str, ...] = ()

    # -- subclass hooks -----------------------------------------------------

    def _tree_axes(self) -> tuple[int, ...]:
        raise NotImplementedError

    def _split_into(self, path: str, data: torch.Tensor) -> None:
        """Run one analysis level of ``data`` and store the children."""
        raise NotImplementedError

    def _merge_children(self, path: str) -> torch.Tensor:
        """Run one synthesis level from the children of ``path``."""
        raise NotImplementedError

    @classmethod
    def _natural_order(cls, level: int) -> list[str]:
        return ["".join(p) for p in product(cls._filter_keys, repeat=level)]

    # -- shared engine ------------------------------------------------------

    def _infer_maxlevel(self) -> int:
        root = self.data[""]
        shortest = min(root.shape[ax] for ax in self._tree_axes())
        return dwt_max_level(shortest, self.wavelet.dec_len)

    def transform(self, data, maxlevel: Optional[int] = None) -> "_LazyPacketTree":
        """(Re)initialize the tree root with new data; returns self.

        A tensor stays on its device, and every node is computed there;
        anything else is moved to the CUDA device.
        """
        self.data = {"": as_device_tensor(data)}
        self.maxlevel = self._infer_maxlevel() if maxlevel is None else maxlevel
        return self

    def initialize(self, keys: Iterable[str]) -> None:
        """Materialize every listed node (parents expand along the way)."""
        for key in keys:
            _ = self[key]

    def reconstruct(self) -> "_LazyPacketTree":
        """Overwrite each node from its children, deepest level first.

        After calling this, every stored node (including the root) reflects
        whatever edits were made to the leaf coefficients.  Operates in
        place and returns self.
        """
        if self.maxlevel is None:
            self.maxlevel = self._infer_maxlevel()
        for depth in range(self.maxlevel - 1, -1, -1):
            for path in self._natural_order(depth):
                rec = self._merge_children(path)
                if path:
                    rec = self._crop_to_parent(rec, path)
                self.data[path] = rec
        return self

    def _child(self, path: str, key: str) -> torch.Tensor:
        node = path + key
        if node not in self.data:
            raise KeyError(f"Key {node} is required to rebuild {path!r} but is not in the tree")
        return self.data[node]

    def _crop_to_parent(self, rec: torch.Tensor, path: str) -> torch.Tensor:
        """Trim the single odd-length pad sample a synthesis step may add."""
        parent = self.data.get(path)
        if parent is None:
            return rec
        for ax in self._tree_axes():
            want = parent.shape[ax]
            grew = rec.shape[ax] - want
            if grew not in (0, 1):
                raise AssertionError(
                    f"node {path!r}: reconstruction produced axis {ax} "
                    f"length {rec.shape[ax]}, expected {want} or {want + 1} "
                    "(decomposition/reconstruction wavelet mismatch?)"
                )
            if grew:
                rec = rec.narrow(ax, 0, want)
        return rec

    def __getitem__(self, key: str) -> torch.Tensor:
        """Return the node's coefficients, expanding parents lazily.

        Raises:
            ValueError: If the tree is uninitialized or the key malformed.
            KeyError: If the key is deeper than ``maxlevel``.
        """
        if self.maxlevel is None:
            raise ValueError(
                "this packet tree holds no data yet — it must be "
                "initialized by calling transform(data) before nodes can "
                "be read"
            )
        if key in self.data:
            return self.data[key]
        if len(key) > self.maxlevel:
            raise KeyError(
                f"node {key!r} sits at depth {len(key)}, too large for "
                f"this tree (maxlevel is {self.maxlevel})"
            )
        if not key:
            raise ValueError("the root node comes from transform(data) and cannot be derived; run transform first")
        stray = sorted(set(key) - set(self._filter_keys))
        if stray:
            raise ValueError(
                f"Invalid key {key!r}: characters {stray} are outside the "
                f"filter alphabet {set(self._filter_keys)}."
            )
        self._split_into(key[:-1], self[key[:-1]])
        return self.data[key]


def _check_orthogonalization(method: str) -> None:
    if method not in ("qr", "gramschmidt"):
        raise NotImplementedError(f"Unsupported orthogonalization {method!r}.")


class WaveletPacket(_LazyPacketTree):
    """A single-dimensional, lazily expanded wavelet packet tree.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> x = torch.arange(16.0)
        >>> wp = ptwt.WaveletPacket(x, "haar", mode="zero", maxlevel=2)
        >>> sorted(node for node in wp.get_level(2))
        ['aa', 'ad', 'da', 'dd']
        >>> int(wp["aa"].shape[-1])
        4
    """

    _filter_keys = ("a", "d")

    @deprecated_alias(boundary_orthogonalization="orthogonalization")
    def __init__(
        self,
        data,
        wavelet: Union[Wavelet, str],
        *,
        mode: ExtendedBoundaryMode = "reflect",
        maxlevel: Optional[int] = None,
        axis: int = -1,
        orthogonalization: OrthogonalizeMethod = "qr",
    ) -> None:
        """Create the packet tree; nodes are computed on first access.

        Args:
            data: The input signal, on the device the tree computes on (a
                non-tensor goes to the CUDA device); None creates an empty
                object (call :meth:`transform` later).
            wavelet: Wavelet name or pywt-compatible object.
            mode: A padding mode, or ``boundary`` for the matrix backend.
            maxlevel: Tree depth (from the signal length if None).
            axis: The transformed axis.
            orthogonalization: Boundary-matrix orthogonalization method
                (``boundary`` mode only).

        Raises:
            NotImplementedError: For unsupported orthogonalization methods.
        """
        super().__init__()
        self.wavelet = _as_wavelet(wavelet)
        self.mode = mode
        self.axis = axis
        self.orthogonalization = orthogonalization
        _check_orthogonalization(orthogonalization)
        self._matrix_wavedec_dict: dict[int, MatrixWavedec] = {}
        self._matrix_waverec_dict: dict[int, MatrixWaverec] = {}
        self.maxlevel: Optional[int] = None
        if data is not None:
            self.transform(data, maxlevel)
        else:
            self.data = {}

    def _tree_axes(self) -> tuple[int, ...]:
        return (self.axis,)

    def _get_wavedec(self, length: int):
        if self.mode == "boundary":
            if length not in self._matrix_wavedec_dict:
                self._matrix_wavedec_dict[length] = MatrixWavedec(
                    self.wavelet, level=1, orthogonalization=self.orthogonalization, axis=self.axis
                )
            return self._matrix_wavedec_dict[length]
        return partial(wavedec, wavelet=self.wavelet, level=1, mode=self.mode, axis=self.axis)

    def _get_waverec(self, length: int):
        if self.mode == "boundary":
            if length not in self._matrix_waverec_dict:
                self._matrix_waverec_dict[length] = MatrixWaverec(
                    self.wavelet, orthogonalization=self.orthogonalization, axis=self.axis
                )
            return self._matrix_waverec_dict[length]
        if self.mode == "periodization":
            return partial(waverec, wavelet=self.wavelet, axis=self.axis, mode=self.mode)
        return partial(waverec, wavelet=self.wavelet, axis=self.axis)

    def _split_into(self, path: str, data: torch.Tensor) -> None:
        lo, hi = self._get_wavedec(data.shape[self.axis])(data)
        self.data[path + "a"] = lo
        self.data[path + "d"] = hi

    def _merge_children(self, path: str) -> torch.Tensor:
        lo = self._child(path, "a")
        hi = self._child(path, "d")
        return self._get_waverec(lo.shape[self.axis])([lo, hi])

    @staticmethod
    def get_level(level: int, order: PacketNodeOrder = "freq") -> list[str]:
        """Return all node paths of a level in frequency or natural order."""
        if order == "freq":
            return _graycode_order(level)
        if order == "natural":
            return WaveletPacket._natural_order(level)
        raise ValueError(f"Unsupported order '{order}'. Choose from 'freq' and 'natural'.")


class WaveletPacket2D(_LazyPacketTree):
    """A two-dimensional, lazily expanded wavelet packet tree.

    Example:
        >>> import torch
        >>> import ptwt_tpu_torch as ptwt
        >>> img = torch.ones(1, 32, 32)
        >>> wp = ptwt.WaveletPacket2D(img, "db2", mode="reflect", maxlevel=2)
        >>> tuple(wp["hv"].shape)  # H then V subband path
        (1, 10, 10)
    """

    _filter_keys = ("a", "h", "v", "d")

    @deprecated_alias(boundary_orthogonalization="orthogonalization")
    def __init__(
        self,
        data,
        wavelet: Union[Wavelet, str],
        *,
        mode: ExtendedBoundaryMode = "reflect",
        maxlevel: Optional[int] = None,
        axes: tuple[int, int] = (-2, -1),
        orthogonalization: OrthogonalizeMethod = "qr",
        separable: bool = False,
    ) -> None:
        """Create the 2d packet tree; see :class:`WaveletPacket`.

        ``separable=True`` runs the padded modes on ``fswavedec2`` /
        ``fswaverec2`` and the matrix backend on its separable operators.

        Raises:
            NotImplementedError: For unsupported orthogonalization methods.
        """
        super().__init__()
        self.wavelet = _as_wavelet(wavelet)
        self.mode = mode
        self.axes = axes
        self.orthogonalization = orthogonalization
        self.separable = separable
        _check_orthogonalization(orthogonalization)
        self.matrix_wavedec2_dict: dict[tuple[int, ...], MatrixWavedec2] = {}
        self.matrix_waverec2_dict: dict[tuple[int, ...], MatrixWaverec2] = {}
        self.maxlevel: Optional[int] = None
        if data is not None:
            self.transform(data, maxlevel)
        else:
            self.data = {}

    def _tree_axes(self) -> tuple[int, ...]:
        return tuple(self.axes)

    def _get_wavedec(self, shape: tuple[int, ...]):
        if self.mode == "boundary":
            if shape not in self.matrix_wavedec2_dict:
                self.matrix_wavedec2_dict[shape] = MatrixWavedec2(
                    self.wavelet,
                    level=1,
                    axes=self.axes,
                    orthogonalization=self.orthogonalization,
                    separable=self.separable,
                )
            return self.matrix_wavedec2_dict[shape]
        if self.separable:

            def _dec(data):
                approx, details = fswavedec2(data, self.wavelet, level=1, mode=self.mode, axes=self.axes)
                # consistent orientation: h = high-pass on rows ("da")
                return approx, WaveletDetailTuple2d(details["da"], details["ad"], details["dd"])

            return _dec
        return partial(wavedec2, wavelet=self.wavelet, level=1, mode=self.mode, axes=self.axes)

    def _get_waverec(self, shape: tuple[int, ...]):
        if self.mode == "boundary":
            if shape not in self.matrix_waverec2_dict:
                self.matrix_waverec2_dict[shape] = MatrixWaverec2(
                    self.wavelet,
                    axes=self.axes,
                    orthogonalization=self.orthogonalization,
                    separable=self.separable,
                )
            return self.matrix_waverec2_dict[shape]
        if self.separable:

            def _rec(coeffs):
                approx, (h, v, d) = coeffs
                return fswaverec2((approx, {"da": h, "ad": v, "dd": d}), self.wavelet, axes=self.axes)

            return _rec
        if self.mode == "periodization":
            return partial(waverec2, wavelet=self.wavelet, axes=self.axes, mode=self.mode)
        return partial(waverec2, wavelet=self.wavelet, axes=self.axes)

    def _split_into(self, path: str, data: torch.Tensor) -> None:
        shape = tuple(data.shape[ax] for ax in self.axes)
        approx, detail = self._get_wavedec(shape)(data)
        self.data[path + "a"] = approx
        self.data[path + "h"] = detail[0]
        self.data[path + "v"] = detail[1]
        self.data[path + "d"] = detail[2]

    def _merge_children(self, path: str) -> torch.Tensor:
        approx = self._child(path, "a")
        detail = WaveletDetailTuple2d(self._child(path, "h"), self._child(path, "v"), self._child(path, "d"))
        shape = tuple(approx.shape[ax] for ax in self.axes)
        return self._get_waverec(shape)((approx, detail))

    @staticmethod
    def get_level(level: int, order: PacketNodeOrder = "freq") -> list[str]:
        """Node paths of a level: Gray-code 2d grid (freq) or flat (natural)."""
        if order == "freq":
            return WaveletPacket2D.get_freq_order(level)
        if order == "natural":
            return WaveletPacket2D.get_natural_order(level)
        raise ValueError(f"Unsupported order '{order}'. Choose from 'freq' and 'natural'.")

    @staticmethod
    def get_natural_order(level: int) -> list[str]:
        """All node paths of a level in natural (lexicographic) order."""
        return WaveletPacket2D._natural_order(level)

    @staticmethod
    def get_freq_order(level: int) -> list[list[str]]:
        """Node paths arranged as a 2d grid in frequency (Gray-code) order.

        Each quadrant label factors into a (row, col) filter pair
        (``a``=(l,l), ``h``=(h,l), ``v``=(l,h), ``d``=(h,h)); rows and
        columns are then Gray-code ordered independently, mirroring pywt.
        """
        row_col_of = {"a": ("l", "l"), "h": ("h", "l"), "v": ("l", "h"), "d": ("h", "h")}
        grid: dict[str, dict[str, str]] = {}
        for node_tuple in product(["a", "h", "v", "d"], repeat=level):
            node = "".join(node_tuple)
            row_path = "".join(row_col_of[c][0] for c in node_tuple)
            col_path = "".join(row_col_of[c][1] for c in node_tuple)
            grid.setdefault(row_path, {})[col_path] = node
        gray = _graycode_order(level, x="l", y="h")
        return [[grid[row][col] for col in gray if col in grid[row]] for row in gray if row in grid]


def get_freq_order(level: int) -> list[list[str]]:
    """Module-level alias of :meth:`WaveletPacket2D.get_freq_order`."""
    return WaveletPacket2D.get_freq_order(level)
