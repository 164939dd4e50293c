"""ResNet backbone family in PyTorch (counterpart of
tpupose/models/backbones/resnet.py).

Module names follow torchvision (conv1, bn1, layerN.M.convK/bnK,
downsample.0/.1), so torchvision-style state dicts load directly and
`tpupose.utils.convert.convert_resnet` maps them onto the JAX tree.

Semantics match the flax model: BatchNorm eps 1e-5 (eval mode uses the
running statistics; train mode normalises with the batch statistics and
updates the running ones as flax does, see `BatchNorm2d`), symmetric
padding 1 on every 3x3 including the
stride-2 ones, padding 0 on the stride-2 1x1 downsample, stem conv 7x7/2
pad 3 and max-pool 3x3/2 pad 1. `forward` takes NCHW; the model runs it
in `channels_last` memory format, which is NHWC in memory.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.models.remat import batch_stats_frozen, block_call


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's train-mode statistics update.

    Train mode normalises with the batch mean and the biased batch
    variance (as torch does) and updates the running statistics as
    flax.linen.BatchNorm does: ra = (1 - m) * ra + m * batch with the
    BIASED batch variance (flax's E[x^2] - E[x]^2), m = `momentum` = 0.1
    (flax momentum 0.9). torch's own update uses the unbiased variance,
    n/(n-1) times larger. The batch statistics come out of the same
    F.batch_norm call (momentum 1 into zeroed buffers gives the batch mean
    and the unbiased variance), so no extra pass over the activations is
    made. Eval mode is nn.BatchNorm2d's. In the recomputation of a
    checkpointed block (models/remat.py) the running statistics are left
    as the first forward set them."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        if batch_stats_frozen():
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var * ((n - 1) / n),
                                                alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, 0, bias=False),
                _bn(planes))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, 1, 0, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride, 0, bias=False), _bn(out))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + r)


_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


def resnet_spec(name: str):
    if name not in _SPECS:
        raise ValueError(f"unknown resnet {name!r}; have {sorted(_SPECS)}")
    return _SPECS[name]


class StemPool(nn.Module):
    """The stem 3x3/2 max-pool, pad 1 (a module of its own, as in the JAX
    package, so the fused stem kernel's coverage is explicit)."""

    def forward(self, x):
        return nn.functional.max_pool2d(x, 3, 2, 1)


class ResNet(nn.Module):
    """ResNet feature extractor: NCHW in, the C5 map out. `remat`
    checkpoints each residual block in training (models/remat.py)."""

    def __init__(self, block_cls, stage_sizes: Sequence[int],
                 remat: bool = False):
        super().__init__()
        self.block_cls = block_cls
        self.stage_sizes = tuple(stage_sizes)
        self.remat = remat
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = StemPool()
        inplanes = 64
        for i, (size, planes) in enumerate(zip(self.stage_sizes,
                                               (64, 128, 256, 512))):
            blocks = []
            for j in range(size):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(inplanes, planes, stride))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = inplanes

    @classmethod
    def from_name(cls, name: str, remat: bool = False) -> "ResNet":
        block, sizes = resnet_spec(name)
        return cls(block, sizes, remat)

    def stem(self, x):
        return self.maxpool(torch.relu(self.bn1(self.conv1(x))))

    def forward(self, x):
        x = self.stem(x)
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                x = block_call(blk, x, self.remat)
        return x
