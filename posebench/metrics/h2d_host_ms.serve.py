"""Host milliseconds a request in the program's `serve.h2d` span (the
copies of the uint8 crops, their centres and scales to the card, which
block the host while they read pageable memory), mean over the measured
window's requests, which ran without the profiler
(tpupose_torch/utils/trace.py). None where the program has no spans."""


def read(s):
    try:
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    if s.host_iters <= 0:
        return None
    return trace.summary(last=s.host_iters,
                         profiled=False)["host_ms"].get("serve.h2d")
