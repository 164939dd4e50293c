"""The normaliser a loss divides its weighted sum by.

Every loss that averages over a count of weighted rows (visible joints,
positives, persons) takes `count`, the function that turns that count
into the normaliser: `local_count` by default, the count of this
process's batch. A data-parallel trainer passes the one of its process
group (parallel/mesh.MeshManager.loss_count), which normalises by the
count over every rank's batch.
"""

from __future__ import annotations

import torch


def local_count(n: torch.Tensor) -> torch.Tensor:
    """max(n, 1), n the loss's count of weighted rows."""
    return torch.clamp_min(n, 1.0)
