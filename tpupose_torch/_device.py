"""Device resolution for the port's entry points.

Entry points take `device="cuda"` by default. A CUDA request on a
machine without CUDA raises instead of running on the CPU: the CPU runs
only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """str | torch.device -> torch.device; raises RuntimeError when CUDA
    is requested and `torch.cuda.is_available()` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
