"""Host milliseconds a step in the program's `train.forward` span (the
train-mode forward and the loss), mean over the measured window's steps,
which ran without the profiler (tpupose_torch/utils/trace.py). None
where the program has no spans."""


def read(s):
    try:
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    if s.host_iters <= 0:
        return None
    return trace.summary(last=s.host_iters,
                         profiled=False)["host_ms"].get("train.forward")
