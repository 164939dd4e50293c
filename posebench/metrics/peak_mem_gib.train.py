"""torch.cuda.max_memory_allocated over the window (the peak statistics
reset as it opens), in GiB."""


def read(s):
    return s.peak_window_bytes / 2 ** 30 if s.peak_window_bytes else None
