"""Bottom-up multi-person pose: heatmaps + associative-embedding tags
(counterpart of tpupose/models/bottom_up.py).

One trunk predicts 2K channels, K joint heatmaps and K scalar tag maps,
trained with losses/ae.ae_loss and grouped by ops/ae_decode.decode_ae,
without a detector. Trunks, both stride 4: an HRNet's high-resolution
branch + a 1x1 conv (`final_layer`, float32 outside autocast), or a
ResNet + the SimpleBaseline deconv head (`head`, 2K channels).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.models.heads import HeatmapHead
from tpupose_torch.models.simcc import make_backbone
from tpupose_torch.models.simple_baseline import (_init_from_generator,
                                                  autocast_call)


class BottomUpPose(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> (B, H/4, W/4, 2K) float32
    (heatmaps then tags). The dtype policy is SimpleBaseline's."""

    def __init__(self, backbone: str = "hrnet_w32", num_keypoints: int = 17,
                 deconv_channels: Sequence[int] = (256, 256, 256),
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        out_ch = 2 * num_keypoints
        self.backbone_name = backbone
        self.num_keypoints = num_keypoints
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.backbone = make_backbone(backbone, remat)
        if backbone.startswith("hrnet"):
            self.final_layer = nn.Conv2d(self.backbone.out_channels, out_ch,
                                         1)
        else:
            self.head = HeatmapHead(self.backbone.out_channels, out_ch,
                                    deconv_channels)
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        (self.final_layer if hasattr(self, "final_layer")
         else self.head.final_layer).float()
        self.eval()

    def _tail(self, f):
        if hasattr(self, "head"):
            return self.head(f)
        with torch.autocast(f.device.type, enabled=False):
            return self.final_layer(f.to(self.final_layer.weight.dtype))

    def forward(self, x):
        y = autocast_call(self, lambda t: self._tail(self.backbone(t)),
                          x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def split(pred):
        """(B, H, W, 2K) -> (heatmaps, tags), each (B, K, H, W) float32
        (the decode's NKHW layout)."""
        K = pred.shape[-1] // 2
        hm = pred[..., :K].permute(0, 3, 1, 2).float()
        tg = pred[..., K:].permute(0, 3, 1, 2).float()
        return hm, tg
