"""Prediction heads (counterpart of tpupose/models/heads.py): the
SimpleBaseline deconv HeatmapHead, DeepPose's RegressionHead and the
ClassifyHead (conv -> GAP -> dropout -> linear). NCHW in. The layers
flax runs in float32 (the heatmap conv, both heads' Dense) run in
float32 outside any autocast region.

flax `ConvTranspose(4x4, stride 2, padding="SAME", transpose_kernel=False)`
is torch `ConvTranspose2d(k=4, s=2, padding=1)` with the kernel rotated
180 degrees in space; `tpupose_torch.utils.convert` applies the rotation
when it carries flax weights across.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpupose_torch.models.backbones.resnet import BatchNorm2d


class HeatmapHead(nn.Module):
    """SimpleBaseline head: N x (deconv 4x4/2 + BN + ReLU), then a 1x1
    conv with bias to K heatmap channels. The final conv runs in float32,
    outside any autocast region (SimpleBaseline keeps `final_layer` in
    float32 whatever the model's dtype). NCHW in and out."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 deconv_channels: Sequence[int] = (256, 256, 256)):
        super().__init__()
        layers = []
        c = in_channels
        for ch in deconv_channels:
            layers += [nn.ConvTranspose2d(c, ch, 4, 2, 1, bias=False),
                       BatchNorm2d(ch, eps=1e-5), nn.ReLU()]
            c = ch
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(c, num_keypoints, 1)

    def forward(self, x):
        x = self.deconv_layers(x)
        with torch.autocast(x.device.type, enabled=False):
            return self.final_layer(x.to(self.final_layer.weight.dtype))


class RegressionHead(nn.Module):
    """DeepPose: GAP -> linear -> (B, K, 2) normalized coordinates."""

    def __init__(self, in_channels: int, num_keypoints: int):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.fc = nn.Linear(in_channels, 2 * num_keypoints)

    def forward(self, x):
        x = x.mean(dim=(2, 3))
        with torch.autocast(x.device.type, enabled=False):
            x = self.fc(x.to(self.fc.weight.dtype))
        return x.reshape(x.shape[0], self.num_keypoints, 2)


class ClassifyHead(nn.Module):
    """1x1 conv (hidden) -> SiLU -> GAP -> dropout -> linear logits; the
    caller applies the softmax."""

    def __init__(self, in_channels: int, num_classes: int,
                 hidden: int = 1280, dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden, 1)
        self.drop = nn.Dropout(dropout)
        self.fc = nn.Linear(hidden, num_classes)

    def forward(self, x):
        x = torch.nn.functional.silu(self.conv(x)).mean(dim=(2, 3))
        x = self.drop(x)
        with torch.autocast(x.device.type, enabled=False):
            return self.fc(x.to(self.fc.weight.dtype))
