"""Device ms per call in the program's own kernels (the ``__global__``
functions of its CUDA sources), from the profiled calls."""


def read(r):
    p = r.profile
    if p is None:
        return None
    total = 0.0
    for name, s, e in p.device:
        if p.is_program_kernel(name):
            total += max(0.0, min(e, p.window[1]) - max(s, p.window[0]))
    return total / p.calls * 1e3 if total > 0 else None
