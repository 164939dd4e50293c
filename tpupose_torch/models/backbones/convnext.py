"""ConvNeXt backbone (counterpart of tpupose/models/backbones/convnext.py):
4x4/4 stem conv + LayerNorm, LayerNorm + 2x2/2 downsample between
stages, ConvNeXt blocks (models/necks.ConvNeXtBlock); returns all four
stage maps (strides 4, 8, 16, 32).

Module names follow the official ConvNeXt checkpoints
(downsample_layers.i, stages.i.j.{dwconv, norm, pwconv1, pwconv2, gamma});
utils/convert.from_flax_dinov3_pose maps the flax tree onto them. The
LayerNorms are over channels (channels-last) with epsilon 1e-6.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tpupose_torch.models.necks import LN_EPS, ConvNeXtBlock
from tpupose_torch.models.remat import block_call

CONVNEXT_SIZES = {
    "atto": {"depths": (2, 2, 6, 2), "dims": (40, 80, 160, 320)},
    "femto": {"depths": (2, 2, 6, 2), "dims": (48, 96, 192, 384)},
    "pico": {"depths": (2, 2, 6, 2), "dims": (64, 128, 256, 512)},
    "nano": {"depths": (2, 2, 8, 2), "dims": (80, 160, 320, 640)},
    "tiny": {"depths": (3, 3, 9, 3), "dims": (96, 192, 384, 768)},
    "small": {"depths": (3, 3, 27, 3), "dims": (96, 192, 384, 768)},
    "base": {"depths": (3, 3, 27, 3), "dims": (128, 256, 512, 1024)},
    "large": {"depths": (3, 3, 27, 3), "dims": (192, 384, 768, 1536)},
    "huge": {"depths": (3, 3, 27, 3), "dims": (352, 704, 1408, 2816)},
}


class ChannelsLastNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """NCHW (B, 3, H, W) -> the four stage maps, NCHW. `remat`
    checkpoints each block while gradients are recorded."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.0, v2: bool = False,
                 remat: bool = False):
        super().__init__()
        self.dims = tuple(dims)
        self.remat = remat
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(3, dims[0], 4, 4), ChannelsLastNorm(dims[0], LN_EPS))])
        for i in range(1, len(dims)):
            self.downsample_layers.append(nn.Sequential(
                ChannelsLastNorm(dims[i - 1], LN_EPS),
                nn.Conv2d(dims[i - 1], dims[i], 2, 2)))
        rates = [float(r) for r in np.linspace(0, drop_path_rate,
                                               sum(depths))]
        self.stages = nn.ModuleList()
        cur = 0
        for depth, dim in zip(depths, dims):
            self.stages.append(nn.Sequential(*(
                ConvNeXtBlock(dim, rates[cur + j], v2=v2)
                for j in range(depth))))
            cur += depth

    @classmethod
    def from_size(cls, size: str, v2: bool = False, remat: bool = False):
        if size not in CONVNEXT_SIZES:
            raise ValueError(f"unknown convnext size {size!r}; have "
                             f"{sorted(CONVNEXT_SIZES)}")
        a = CONVNEXT_SIZES[size]
        return cls(a["depths"], a["dims"], v2=v2, remat=remat)

    def forward(self, x: torch.Tensor):
        feats = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for blk in stage:
                x = block_call(blk, x, self.remat)
            feats.append(x)
        return feats
