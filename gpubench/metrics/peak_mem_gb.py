"""``torch.cuda.max_memory_allocated()`` over set-up and window, after a
reset at the process's start, in GB (1e9 bytes)."""


def read(rec):
    return rec.peak_bytes / 1e9 if rec.peak_bytes else None
