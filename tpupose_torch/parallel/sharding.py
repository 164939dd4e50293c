"""Parameter placement for the (data, model) mesh (counterpart of
tpupose/parallel/sharding.py): every parameter and buffer is replicated
over the ranks (each takes rank 0's copy), and with a model axis of
more than one rank the wide layers' output channels are sharded over it
(parallel/tensor_parallel.shard_module, JAX's rule: output channels at
least `min_channels` and divisible by the axis).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpupose_torch.parallel.tensor_parallel import shard_module


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (nothing to do without a process group)."""
    if dist.is_available() and dist.is_initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def shard_params(module: torch.nn.Module, model_size: int = 1,
                 model_rank: int = 0, model_group=None,
                 min_channels: int = 64) -> torch.nn.Module:
    """JAX's shard_params: `module` replicated from rank 0 over every
    rank (so over the data group), then, where model_size > 1, its wide
    layers sharded over the model group, this process being
    `model_rank` of it."""
    replicate(module)
    shard_module(module, model_rank, model_size, model_group, min_channels)
    return module
