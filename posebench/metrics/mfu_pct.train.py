"""Model FLOPs of the run's untraced steps (three times each sample's
forward: the forward and a backward of twice its work;
posebench/counts/models.py) over their host wall time times the card's
bf16 peak: the profiler's own host cost would lower it in the traced
segment."""

from posebench.counts.models import forward_flops
from posebench.peaks import BF16_FLOPS


def read(s):
    if s.host_iters <= 0 or s.host_s <= 0:
        return None
    per_iter = 3 * forward_flops(s.widths) * s.batch
    return 100.0 * per_iter * s.host_iters / (s.host_s * BF16_FLOPS)
