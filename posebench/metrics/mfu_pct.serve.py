"""Model FLOPs of the run's untraced requests (every crop's forward,
twice under the flip test; posebench/counts/models.py) over their host
wall time times the card's bf16 peak: the profiler's own host cost would
lower it in the traced segment."""

from posebench.counts.models import forward_flops
from posebench.peaks import BF16_FLOPS


def read(s):
    if s.host_iters <= 0 or s.host_s <= 0:
        return None
    per_iter = forward_flops(s.widths) * s.batch * (2 if s.flip else 1)
    return 100.0 * per_iter * s.host_iters / (s.host_s * BF16_FLOPS)
