"""Synchronised BatchNorm: train-mode statistics over the GLOBAL batch,
the other half of JAX's data-parallel semantics (under jit sharding a
flax BatchNorm's mean and variance are over the whole sharded batch,
tests/test_dp_equivalence.py).

`SyncBatchNorm2d` is the port's BatchNorm2d (flax's running-statistics
update, models/backbones/resnet.py) whose train-mode batch statistics
come from one all-reduce of each channel's (sum, sum of squares, count)
over the process group, and whose backward all-reduces the two sums the
statistics' gradient needs: the gradient through the statistics reaches
every rank's activations, as one process's would. Mean and biased
variance are E[x] and E[x^2] - E[x]^2 in float32 (flax's fast
variance). One path serves both devices: float32 ops around the
differentiable torch.distributed.nn.functional.all_reduce (NCCL on the
card, gloo in the tests; torch.nn.SyncBatchNorm raises for a CPU
tensor, so it could not be held against JAX here); the output has the
input's dtype. Eval mode, and train mode without a process group, are
BatchNorm2d's own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpupose_torch.models.backbones.resnet import BatchNorm2d
from tpupose_torch.models.remat import batch_stats_frozen


class SyncBatchNorm2d(BatchNorm2d):
    # the process group: the mesh's data group (None: the default one);
    # under tensor parallelism the model ranks hold the same, replicated
    # activation, so the statistics sum over the data ranks alone
    group = None

    def forward(self, x):
        if not self.training or not (dist.is_available()
                                     and dist.is_initialized()):
            return super().forward(x)
        y, mean, var = self._stats_and_normalize(x)
        if not batch_stats_frozen():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
        return y

    def _stats_and_normalize(self, x):
        """(y, global mean, global biased variance): the statistics' sums
        all-reduced by the differentiable
        torch.distributed.nn.functional.all_reduce, the normalisation in
        float32 ops."""
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        C = x.shape[1]
        n = torch.full((1,), x.numel() // C, dtype=torch.float32,
                       device=x.device)
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), n])
        stats = all_reduce(stats, group=self.group)
        count = stats[-1]
        mean = stats[:C] / count
        var = (stats[C:2 * C] / count - mean * mean).clamp_min(0.0)
        shape = (1, C, 1, 1)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.eps)
        if self.affine:
            y = y * self.weight.float().reshape(shape) \
                + self.bias.float().reshape(shape)
        return y.to(x.dtype), mean, var


def convert_sync_batchnorm(module: torch.nn.Module,
                           group=None) -> torch.nn.Module:
    """Every BatchNorm2d of `module` becomes a SyncBatchNorm2d over
    `group`, in place (parameters, buffers and hooks kept)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = SyncBatchNorm2d
            m.group = group
    return module
