"""K7's share of its roofline: the least time for a step's affine warp
of its uint8 crops to float32 (bytes-bound) over the device time of K7
(csrc/warp.cu) in the traced steps."""

from posebench.counts.kernels import warp
from posebench.peaks import least_seconds

PATTERN = r"warp_kernel"


def read(s):
    t = s.device_s(PATTERN)
    if t <= 0:
        return None
    H, W = s.widths["image_size"]
    ops, nbytes = warp(s.batch, H, W, 3)
    return 100.0 * least_seconds(ops, nbytes) * s.iters / t
