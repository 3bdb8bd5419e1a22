"""peak_gib: the device memory the window allocated at its peak
(torch.cuda.max_memory_allocated after reset_peak_memory_stats), GiB."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2**30
