"""Device resolution for the port's entry points, the models' dtype
policy (`autocast_inputs`), and what code that a CUDA graph may capture
asks of the device (`capturing`, `constant`).

Entry points take `device="cuda"` by default. A CUDA request on a
machine without CUDA raises instead of running on the CPU: the CPU runs
only when the caller asks for it.
"""

from __future__ import annotations

import contextlib
import functools

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


def capturing() -> bool:
    """True while this thread's current CUDA stream is being captured into
    a graph (engine/step_graphs.py): a value filled or an event recorded
    then would be frozen into the graph or refused."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device: torch.device) -> torch.Tensor:
    """`torch.tensor(values, device=device)`, made once per values and
    device: a tensor made from a Python list on the card is a synchronous
    copy, which a graph capture refuses. The tensor is shared: never
    write to it."""
    return torch.tensor(values, device=device)
