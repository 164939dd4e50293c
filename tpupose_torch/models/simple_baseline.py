"""SimpleBaseline: ResNet + deconv heatmap head (counterpart of
tpupose/models/simple_baseline.py). Top-down single-person pose, e.g.
256x192 crops -> 64x48 heatmaps."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.models.backbones.resnet import ResNet
from tpupose_torch.models.heads import HeatmapHead


class SimpleBaseline(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> heatmaps (B, H/4, W/4, K).

    Built on `device` (default "cuda"; raises if CUDA is absent) in
    `dtype`, with the head's final 1x1 conv kept in float32 and every
    parameter in `channels_last` memory format. Weights come from the
    module initializers under `generator` (seeded when given), or from a
    state dict (see tpupose_torch.utils.convert)."""

    def __init__(self, backbone: str = "resnet50", num_keypoints: int = 17,
                 deconv_channels: Sequence[int] = (256, 256, 256),
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.backbone_name = backbone
        self.num_keypoints = num_keypoints
        self.backbone = ResNet.from_name(backbone)
        self.head = HeatmapHead(self.backbone.out_channels, num_keypoints,
                                deconv_channels)
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=dtype, memory_format=torch.channels_last)
        self.head.final_layer.float()
        self.eval()

    def forward(self, x):
        y = self.head(self.backbone(x.permute(0, 3, 1, 2)))
        return y.permute(0, 2, 3, 1)


@torch.no_grad()
def _init_from_generator(model: nn.Module, g: torch.Generator):
    """Seeded re-initialisation on the CPU: He-normal convs, unit BN
    scale, zero BN bias, and non-trivial running statistics (so a BN fold
    is exercised), all drawn from `g`."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) \
                else m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            m.weight.copy_(torch.empty(c).uniform_(0.5, 1.0, generator=g))
            m.bias.copy_(torch.randn(c, generator=g) * 0.1)
            m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
            m.running_var.copy_(torch.empty(c).uniform_(0.5, 2.0,
                                                        generator=g))
