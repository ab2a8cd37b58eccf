"""The device's timeline over a few calls, from ``torch.profiler``.

The harness profiles calls back to back after the window, their inputs
made beforehand, so the timeline holds the calls' own work.  The first
call is traced and dropped: on an H100 a window's first device records
went missing.  Everything the per-layer readers need is kept here as
plain intervals in seconds: device operations (kernels, copies, fills)
and host events (operators, the harness's own spans), and the window from
the first call's start to the last call's end.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from pathlib import Path

CALL, FINISH = "portbench.call", "portbench.finish"
_NAME_CHARS = 120


@dataclass
class Profile:
    device: list  # (name, start_s, end_s)
    host: list  # (name, start_s, end_s)
    window: tuple  # (start_s, end_s)
    calls: int
    kernel_names: frozenset = field(default_factory=frozenset)

    def busy(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in merged(self.device, self.window))

    def is_program_kernel(self, name: str) -> bool:
        return any(re.search(rf"\b{k}\b", name) for k in self.kernel_names)


def merged(device: list, window: tuple) -> list:
    """The union of the device intervals, clipped to ``window``."""
    lo, hi = window
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in device if e > lo and s < hi)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def program_kernel_names(csrc: Path) -> frozenset:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            rest = text[m.end():]
            if rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                while True:
                    depth += {"(": 1, ")": -1}.get(rest[i], 0)
                    i += 1
                    if depth == 0:
                        break
                rest = rest[i:]
            ident = re.match(r"\s*(\w+)", rest)
            if ident:
                names.add(ident.group(1))
    return frozenset(names)


def _short(name: str) -> str:
    return name if len(name) <= _NAME_CHARS else name[: _NAME_CHARS - 3] + "..."


def profile_calls(loop, inputs: list, kernel_names: frozenset) -> Profile:
    """Profile ``loop``'s calls on ``inputs`` (the first traced and
    dropped) and return the timeline of the others."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    active = len(inputs) - 1
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=active, repeat=1),
    ) as prof:
        for x in inputs:
            with record_function(CALL):
                loop.call(x)
            with record_function(FINISH):
                loop.finish()
            loop.drop()
            prof.step()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        if e.is_user_annotation() or e.name() in (CALL, FINISH):
            # the harness's spans; on the device's timeline too, where
            # they are no device work
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(span)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(span)
        elif not e.name().startswith("ProfilerStep"):
            host.append(span)
    calls = [h for h in host if h[0] == CALL]
    finishes = [h for h in host if h[0] == FINISH]
    if len(calls) != active or len(finishes) != active:
        raise RuntimeError(f"the profile holds {len(calls)} calls and {len(finishes)} finishes of {active}")
    window = (min(s for _, s, _ in calls), max(e for _, _, e in finishes))
    return Profile(device, host, window, active, kernel_names)


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps'
    time by what the host was doing (the innermost host event open at
    each gap's middle), both in seconds over the profiled calls."""
    ops: dict = {}
    for name, s, e in p.device:
        lo, hi = max(s, p.window[0]), min(e, p.window[1])
        if hi > lo:
            ops[_short(name)] = ops.get(_short(name), 0.0) + (hi - lo)
    host = sorted(p.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: dict = {}
    busy = merged(p.device, p.window)
    edges = [p.window[0], *[t for span in busy for t in span], p.window[1]]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid, name = 0.5 * (s + e), "no host event"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][2] >= mid:
                name = _short(host[i][0])
                break
        gaps[name] = gaps.get(name, 0.0) + (e - s)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}
