"""Seeding (the port's copy of tpupose/utils/seed.py; reference:
HPE/utils/dist.py:14-43 set_seed).

Seeds Python's `random`, numpy and torch (every device). The JAX
package returns a PRNGKey instead; the port's explicit randomness
(weight init, augmentation draws) comes from `torch.Generator`s that
the callers seed themselves.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42, deterministic: bool = False) -> int:
    """Seed python/numpy/torch; with `deterministic`, cuDNN picks
    deterministic algorithms and does not benchmark. Returns the seed."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return seed
