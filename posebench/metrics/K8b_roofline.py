"""K8b's share of its roofline: the least time for the attention
gradient of every ViT block of a step over the device time of K8b's two
kernels (csrc/flash_attention_bwd.cu) in the traced steps."""

from posebench.counts.kernels import attention_backward
from posebench.peaks import least_seconds

PATTERN = r"flash_attention_(dq|dkv)_kernel"


def read(s):
    t = s.device_s(PATTERN)
    if t <= 0:
        return None
    w = s.widths
    H, W = w["image_size"]
    p = w["patch_size"]
    L = (H // p) * (W // p) + 1 + w["storage_tokens"]
    ops, nbytes = attention_backward(s.batch, w["heads"], L,
                                     w["dim"] // w["heads"])
    return 100.0 * least_seconds(ops, nbytes) * w["depth"] * s.iters / t
