"""The 95th percentile over all calls of the window, each from the start
of its dispatch to its completion, in ms."""

import statistics


def read(r):
    if len(r.calls) < 20:
        return None
    return statistics.quantiles([(c - s) * 1e3 for s, _, c in r.calls], n=100, method="inclusive")[94]
