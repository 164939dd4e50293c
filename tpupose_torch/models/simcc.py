"""SimCC: coordinate classification pose head (counterpart of
tpupose/models/simcc.py; Li et al., ECCV 2022).

A ResNet or HRNet backbone, a 1x1 conv to K channels, a per-keypoint
flatten and two linear layers to Wb x bins and Hb y bins (Wb = W *
split_ratio, Hb = H * split_ratio). `cfg.model.heatmap_size` is the bin
grid (Hb, Wb), so the dataset's joint transform, the affine
back-projection and the evaluator serve this family as they serve the
heatmap one. The flatten takes each keypoint's (h, w) map in row-major
order, as flax's NHWC -> (B, K, h*w) transpose does; the linear layers'
input size is h*w, so the model is built for one input size.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.models.simple_baseline import (_init_from_generator,
                                                  autocast_call)


def feature_hw(backbone: str, image_size: Sequence[int]):
    """The backbone's output size for an (H, W) input: stride 32 for a
    ResNet, 4 for an HRNet, each stride-2 layer rounding up (padding
    k // 2, as flax's SAME at these kernels)."""
    n = 2 if backbone.startswith("hrnet") else 5
    h, w = image_size
    for _ in range(n):
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return h, w


def make_backbone(backbone: str, remat: bool = False) -> nn.Module:
    """A ResNet or HRNet backbone by name (NCHW in, features out)."""
    from tpupose_torch.models.backbones.hrnet import HRNet
    from tpupose_torch.models.backbones.resnet import ResNet

    if backbone.startswith("hrnet"):
        return HRNet.from_name(backbone, remat)
    return ResNet.from_name(backbone, remat)


class SimCCHead(nn.Module):
    """1x1 conv (`kpt_conv`, the model's dtype) -> per-keypoint flatten ->
    `mlp_x` to the x bins and `mlp_y` to the y bins, float32 outside
    autocast. NCHW in; (x_logits (B, K, Wb), y_logits (B, K, Hb)) out."""

    def __init__(self, in_channels: int, num_keypoints: int, x_bins: int,
                 y_bins: int, feat_hw: Sequence[int]):
        super().__init__()
        n = feat_hw[0] * feat_hw[1]
        self.kpt_conv = nn.Conv2d(in_channels, num_keypoints, 1)
        self.mlp_x = nn.Linear(n, x_bins)
        self.mlp_y = nn.Linear(n, y_bins)

    def forward(self, x):
        x = self.kpt_conv(x)
        B, K = x.shape[:2]
        t = x.reshape(B, K, -1)
        with torch.autocast(x.device.type, enabled=False):
            t = t.to(self.mlp_x.weight.dtype)
            return self.mlp_x(t), self.mlp_y(t)


class SimCCPose(nn.Module):
    """NHWC (B, H, W, 3) normalized images of `image_size` -> (x_logits
    (B, K, W * split_ratio), y_logits (B, K, H * split_ratio)).

    The dtype policy is SimpleBaseline's (float32 masters under bf16
    autocast with `param_dtype=float32`, `device` default "cuda"); the
    two bin projections run in float32 (a stable softmax / KL)."""

    def __init__(self, backbone: str = "resnet50", num_keypoints: int = 17,
                 split_ratio: float = 2.0, image_size=(256, 192),
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        H, W = image_size
        self.backbone_name = backbone
        self.num_keypoints = num_keypoints
        self.image_size = (H, W)
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.backbone = make_backbone(backbone, remat)
        self.head = SimCCHead(self.backbone.out_channels, num_keypoints,
                              int(W * split_ratio), int(H * split_ratio),
                              feature_hw(backbone, (H, W)))
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        self.head.mlp_x.float()
        self.head.mlp_y.float()
        self.eval()

    def forward(self, x):
        if tuple(x.shape[1:3]) != self.image_size:
            raise ValueError(f"SimCCPose was built for {self.image_size} "
                             f"inputs, got {tuple(x.shape[1:3])}")
        return autocast_call(self, lambda t: self.head(self.backbone(t)),
                             x.permute(0, 3, 1, 2))
