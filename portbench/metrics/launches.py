"""The program's hand-kernel launches per call (``ops/_kernels.LAUNCHES``,
reset before each call), the median over the window's calls."""

import statistics


def read(r):
    if not r.on_device or not r.launches:
        return None
    return float(statistics.median(sum(c.values()) for c in r.launches))
