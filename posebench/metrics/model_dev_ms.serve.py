"""Device milliseconds a request in the program's `serve.model` span
(normalise, the forward and the flipped forward): the elapsed time of its
CUDA events, kernels and the gaps the host leaves between them, mean
over the traced requests (tpupose_torch/utils/trace.py). None where the
program has no spans, or off the card."""


def read(s):
    try:
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    return trace.summary(last=s.iters,
                         profiled=True)["device_ms"].get("serve.model")
