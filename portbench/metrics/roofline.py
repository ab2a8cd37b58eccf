"""A call's least time on the device over its device busy time, in %.

The least time is the larger of the call's least bytes over the peak
bandwidth and its least operations over the peak float32 rate
(``cost/<loop>.py``, ``cost/peaks.json``); busy is the union of the
device's operations over the profiled calls, per call."""


def read(r):
    p = r.profile
    if p is None or r.peak_rates is None:
        return None
    busy = p.busy() / p.calls
    if busy <= 0:
        return None
    nbytes, ops = r.cost
    least = max(nbytes / r.peak_rates["bytes_per_s"], ops / r.peak_rates["flops_per_s"])
    return 100.0 * least / busy
