"""Share of the profiled window in which no device operation ran, in %."""


def read(r):
    p = r.profile
    if p is None or not p.device:
        return None
    span = p.window[1] - p.window[0]
    return 100.0 * (1.0 - p.busy() / span)
