"""Kernel launches a request, from the trace's device kernels (copies
and memsets not counted)."""


def read(s):
    return s.kernel_count() / s.iters
