"""Selective rematerialization (gradient checkpointing) of the backbones'
blocks (counterpart of tpupose/models/remat.py).

`block_call(mod, x, remat)` runs a block under `torch.utils.checkpoint`
(non-reentrant) while gradients are recorded: its activations are not
kept for the backward pass but recomputed there, one block at a time.
The module is called as it is, so the parameter names do not change with
the flag (tests/test_remat.py's point for flax).

The trap this module exists for: the recomputation runs the block's
forward a second time, in train mode, and a BatchNorm there would update
its running statistics again (a `checkpoint(bn, x)` plus `backward()`
leaves `num_batches_tracked == 2`). JAX's remat has no such effect,
because flax's state is functional. Here the recomputation runs under
`frozen_batch_stats()`, during which the port's `BatchNorm2d` normalises
with the batch statistics as before but leaves its running statistics
alone: they keep the values of the first forward only.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

_STATE = threading.local()


def batch_stats_frozen() -> bool:
    """True inside `frozen_batch_stats()` on this thread (the backward's
    recomputation of a checkpointed block)."""
    return getattr(_STATE, "depth", 0) > 0


@contextlib.contextmanager
def frozen_batch_stats():
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def _contexts():
    return contextlib.nullcontext(), frozen_batch_stats()


def block_call(mod, x, remat: bool):
    """`mod(x)`, checkpointed when `remat` and gradients are recorded."""
    if remat and torch.is_grad_enabled():
        return checkpoint(mod, x, use_reentrant=False, context_fn=_contexts)
    return mod(x)
