"""What a run hands its metric readers (``metrics/<name>.py``).

Every reader is a module with ``read(r: Readings) -> float | None``; it
returns None where it finds nothing to read, and the harness then leaves
the metric out of the result.  Host times are ``time.perf_counter()``
seconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .trace import Profile


@dataclass
class Readings:
    on_device: bool  # a CUDA device ran the calls
    setup_s: float  # process start to the window's start
    window_start: float
    calls: list  # (start, returned, completed) of every call of the window
    launches: list  # the program's launches by kernel, one dict per call
    elements_per_call: int  # input elements (pixels, samples) of a call
    peak_bytes: Optional[int]  # torch.cuda.max_memory_allocated over the window
    cost: tuple  # (bytes, operations): a call's least work (cost/<loop>.py)
    peak_rates: Optional[dict]  # the device's published peaks (cost/peaks.json)
    profile: Optional[Profile]  # with --trace 1
