"""Megabytes (1e6 bytes) a request copied to the card from pageable host
memory: the program's `serve.h2d_pageable_bytes` counter (numpy arrays
and unpinned CPU tensors in `serve.h2d`), mean over the measured
window's requests (tpupose_torch/utils/trace.py). None where the program
has no such counter."""


def read(s):
    try:
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    if s.host_iters <= 0:
        return None
    n = trace.summary(last=s.host_iters, profiled=False)["counts"].get(
        "serve.h2d_pageable_bytes")
    return None if n is None else n / 1e6
