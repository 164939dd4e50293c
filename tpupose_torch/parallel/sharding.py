"""Parameter placement for the (data, model) mesh (counterpart of
tpupose/parallel/sharding.py). With mesh.model == 1, the only layout
ported, every parameter and buffer is replicated: each rank holds rank
0's copy. The tensor-parallel layout (wide output channels sharded over
'model') raises, citing ROADMAP Queue A item 12e.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpupose_torch.parallel.mesh import tensor_parallel_error


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (nothing to do without a process group)."""
    if dist.is_available() and dist.is_initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def shard_params(module: torch.nn.Module,
                 model_size: int = 1) -> torch.nn.Module:
    """JAX's shard_params: replication at model_size 1; a tensor-parallel
    layout (model_size > 1) raises (Queue A item 12e)."""
    if model_size > 1:
        raise tensor_parallel_error(model_size)
    return replicate(module)
