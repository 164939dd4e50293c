"""Device milliseconds a request in the program's `serve.post` spans (the
flip merge, then the DARK decode K4 and the back-projection): the
elapsed time of their CUDA events, mean over the traced requests
(tpupose_torch/utils/trace.py). None where the program has no spans, or
off the card."""


def read(s):
    try:
        from tpupose_torch.utils import trace
    except ImportError:
        return None
    return trace.summary(last=s.iters,
                         profiled=True)["device_ms"].get("serve.post")
