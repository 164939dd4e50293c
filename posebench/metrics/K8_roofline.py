"""K8's share of its roofline: the least time for the attention of every
ViT block of a request's forwards (flip test: two) over the device time
of K8 (csrc/flash_attention.cu) in the traced requests."""

from posebench.counts.kernels import attention_forward
from posebench.peaks import least_seconds

PATTERN = r"flash_attention_kernel"


def tokens(w) -> int:
    H, W = w["image_size"]
    p = w["patch_size"]
    return (H // p) * (W // p) + 1 + w["storage_tokens"]


def read(s):
    t = s.device_s(PATTERN)
    if t <= 0:
        return None
    w = s.widths
    b = s.batch * (2 if s.flip and not s.train else 1)
    ops, nbytes = attention_forward(b, w["heads"], tokens(w),
                                    w["dim"] // w["heads"], lse=s.train)
    return 100.0 * least_seconds(ops, nbytes) * w["depth"] * s.iters / t
