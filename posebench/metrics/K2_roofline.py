"""K2's share of its roofline: the least time the card could take for
ResNet layer1 on a request's crops (each forward of the flip test) over
the device time of K2 (csrc/bottleneck.cu) in the traced requests."""

from posebench.counts.kernels import layer1
from posebench.peaks import least_seconds

PATTERN = r"(?<![a-z0-9_])bottleneck_kernel"


def read(s):
    t = s.device_s(PATTERN)
    if t <= 0:
        return None
    ops, nbytes = layer1(s.batch * (2 if s.flip else 1), s.widths)
    return 100.0 * least_seconds(ops, nbytes) * s.iters / t
