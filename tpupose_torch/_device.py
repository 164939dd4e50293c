"""Device resolution for the port's entry points, and the models' dtype
policy (`autocast_inputs`).

Entry points take `device="cuda"` by default. A CUDA request on a
machine without CUDA raises instead of running on the CPU: the CPU runs
only when the caller asks for it.
"""

from __future__ import annotations

import contextlib

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


def autocast_inputs(x: torch.Tensor, compute_dtype: torch.dtype,
                    param_dtype: torch.dtype):
    """The models' dtype policy: (input, context) -- bf16 autocast on x's
    device over float32 masters where `compute_dtype` and `param_dtype`
    differ, else x cast to the parameters' dtype and no context."""
    if compute_dtype == param_dtype:
        return x.to(param_dtype), contextlib.nullcontext()
    return x, torch.autocast(x.device.type, dtype=compute_dtype)
