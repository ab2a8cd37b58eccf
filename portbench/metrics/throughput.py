"""Input elements of every call completed in the window over the time
from the window's start to the last completion, in millions a second."""


def read(r):
    if not r.calls:
        return None
    return r.elements_per_call * len(r.calls) / (r.calls[-1][2] - r.window_start) / 1e6
