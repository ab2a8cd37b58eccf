"""Process start to the window's start, in seconds: imports, the kernels'
build or load, the seeded inputs and the warm-up."""


def read(r):
    return r.setup_s
