"""``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(r):
    return None if r.peak_bytes is None else r.peak_bytes / 2**30
