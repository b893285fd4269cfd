"""peak_device_gib: ``torch.cuda.max_memory_allocated()`` from the
service's construction (after the data was made) to the window's close."""


def read(r):
    return None if r.peak_bytes is None else r.peak_bytes / 2**30
