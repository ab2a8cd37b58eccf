"""Device ms per call in every other device operation (elementwise,
copies, fills, reductions, autograd's sums), from the profiled calls."""


def read(r):
    p = r.profile
    if p is None or not p.device:
        return None
    total = 0.0
    for name, s, e in p.device:
        if not p.is_program_kernel(name):
            total += max(0.0, min(e, p.window[1]) - max(s, p.window[0]))
    return total / p.calls * 1e3
