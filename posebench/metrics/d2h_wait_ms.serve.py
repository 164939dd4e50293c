"""Host milliseconds a request blocked in the program's `serve.d2h` span
(the copies of coordinates and scores to the host, which wait for the
card to finish the request), mean over the measured window's requests,
which ran without the profiler (tpupose_torch/utils/trace.py). Near 0:
the host sets the pace. None where the program has no spans."""


def read(s):
    try:
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    if s.host_iters <= 0:
        return None
    return trace.summary(last=s.host_iters,
                         profiled=False)["host_ms"].get("serve.d2h")
