"""The explicit-collective data-parallel train step (counterpart of
tpupose/parallel/shard_map_step.py, make_shard_map_train_step).

Each rank computes the gradients of its local batch, the gradients and
the loss are averaged over the process group by one all-reduce each (a
flat bucket of every gradient, the analog of JAX's pmean over 'data'),
and every rank applies the identical update. The Trainer's path is
DistributedDataParallel, which overlaps the same all-reduce with the
backward; this form is for per-step control. A model with BatchNorm
needs sync_bn.convert_sync_batchnorm for global statistics (JAX's
shard_map form keeps per-shard statistics). On a (data, model) mesh
both take the data group (MeshManager.data_group): the model ranks of
one data index hold the same batch, and a sharded weight's gradient is
averaged with the same block on the other data ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_mean_(tensors, group=None):
    """Average `tensors` over the group in place, through one flat
    bucket (nothing to do without a group)."""
    tensors = list(tensors)
    if not tensors or not (dist.is_available() and dist.is_initialized()):
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    pos = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[pos:pos + n].view_as(t))
        pos += n
    return tensors


def make_allreduce_train_step(model: torch.nn.Module, loss_fn, optimizer,
                              group=None):
    """`step(inputs, *targets) -> loss`: the train-mode forward of the
    local batch, loss_fn(preds, *targets), backward, the gradients and
    the loss averaged over the group, then optimizer.step() on every
    rank. Returns the group's mean loss (a detached tensor)."""

    def step(inputs, *targets):
        optimizer.zero_grad()
        loss = loss_fn(model.train()(inputs), *targets)
        loss.backward()
        all_reduce_mean_([p.grad for p in model.parameters()
                          if p.grad is not None], group)
        optimizer.step()
        return all_reduce_mean_([loss.detach().clone()], group)[0]

    return step
