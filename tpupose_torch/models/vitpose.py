"""ViTPose: a plain ViT backbone (models/backbones/vit.DinoViT) and a
light heatmap decoder (counterpart of tpupose/models/vitpose.py).
Top-down, e.g. 256x192 crops -> 64x48 heatmaps.

Decoders:
  "classic": 2 x [deconv 4x4/2 + BatchNorm + ReLU] then a 1x1 conv,
             /16 -> /4; the SimpleBaseline head (models/heads.HeatmapHead);
  "simple":  4x bilinear upsample (align_corners=False, no antialias,
             which equals jax.image.resize's bilinear for an integer
             upscale, edges included), 3x3 conv + ReLU, 1x1 conv.
Either final conv runs in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.models.backbones.vit import DinoViT, LayerScale
from tpupose_torch.models.heads import HeatmapHead
from tpupose_torch.models.simple_baseline import (init_like_flax,
                                                  randomize_batchnorm)


class SimpleDecoder(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_keypoints: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.final_layer = nn.Conv2d(channels, num_keypoints, 1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=4, mode="bilinear",
                          align_corners=False, antialias=False)
        x = torch.relu(self.conv(x))
        with torch.autocast(x.device.type, enabled=False):
            return self.final_layer(x.to(self.final_layer.weight.dtype))


class ViTPose(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> heatmaps (B, H/4, W/4, K).

    `backbone` is vit_{small,base,...} or dinov3_vit_... (a VIT_SIZES
    key after the prefix). Built on `device` (default "cuda"; raises if
    CUDA is absent) with parameters in `param_dtype` (default `dtype`,
    the serving build); with float32 parameters and a bf16 `dtype` the
    forward runs under bf16 autocast, the SimpleBaseline's policy.
    `freeze_backbone` stops the gradient at the backbone's feature map
    (JAX's stop_gradient): the backbone runs without recording a graph,
    so no backbone gradient is computed. `remat` checkpoints each ViT
    block in training (DinoViT(remat=True)); it changes no parameter
    name and no value. Weights: the module initializers, `generator` (seeded, non-trivial
    layer scales, LayerNorm affines and BatchNorm statistics),
    `init_vitpose_like_flax`, or a state dict
    (utils/convert.from_flax_vitpose)."""

    def __init__(self, backbone: str = "vit_small", num_keypoints: int = 17,
                 decoder: str = "classic",
                 deconv_channels: Sequence[int] = (256, 256),
                 freeze_backbone: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.backbone_name = backbone
        self.num_keypoints = num_keypoints
        self.decoder = decoder
        self.freeze_backbone = freeze_backbone
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        size = backbone.replace("dinov3_", "").replace("vit_", "")
        self.backbone = DinoViT.from_size(size, remat=remat)
        dim = self.backbone.dim
        if decoder == "classic":
            self.head = HeatmapHead(dim, num_keypoints, deconv_channels)
        elif decoder == "simple":
            self.head = SimpleDecoder(dim, deconv_channels[-1], num_keypoints)
        else:
            raise ValueError(f"unknown decoder {decoder!r}")
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        self.head.final_layer.float()
        self.eval()

    def _forward(self, x):
        if self.freeze_backbone:
            with torch.no_grad():
                feats = self.backbone(x)["feature_map"]
        else:
            feats = self.backbone(x)["feature_map"]        # (B, h, w, C)
        return self.head(feats.permute(0, 3, 1, 2))

    def forward(self, x):
        if self.compute_dtype == self.param_dtype:
            y = self._forward(x.to(self.param_dtype))
        else:
            with torch.autocast(x.device.type, dtype=self.compute_dtype):
                y = self._forward(x)
        return y.permute(0, 2, 3, 1)


@torch.no_grad()
def init_vitpose_like_flax(model: ViTPose, g: torch.Generator):
    """flax's initializers drawn from `g` on the CPU (the init of
    tpupose's ViTPose): lecun_normal Dense/Conv/ConvTranspose kernels,
    zero biases, unit LayerNorm/BatchNorm scales, truncated_normal(0.02)
    CLS and storage tokens, layer scales 1e-5."""
    init_like_flax(model, g)
    init_vit_like_flax(model.backbone, g)


@torch.no_grad()
def init_vit_like_flax(vit: DinoViT, g: torch.Generator):
    """The DinoViT's own flax initializers after `init_like_flax`:
    truncated_normal(0.02) CLS and storage tokens drawn from `g`, layer
    scales 1e-5."""
    for p in (vit.cls_token, vit.storage_tokens):
        w = torch.empty(p.shape)
        nn.init.trunc_normal_(w, 0.0, 0.02, -0.04, 0.04, generator=g)
        p.copy_(w)
    for m in vit.modules():
        if isinstance(m, LayerScale):
            m.gamma.fill_(1e-5)


@torch.no_grad()
def _init_from_generator(model: ViTPose, g: torch.Generator):
    """Seeded weights under which attention shows in the output: lecun
    normal Linear/Conv weights with small biases, layer scales U(0.2,
    0.6) (flax's 1e-5 would make the blocks near no-ops), LayerNorm
    affines around (1, 0), N(0, 0.5) tokens, and non-trivial BatchNorm
    statistics; all drawn from `g` on the CPU."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = (m.weight.shape[0] * m.weight[0, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (1.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.02)
        elif isinstance(m, nn.LayerNorm):
            c = m.normalized_shape[0]
            m.weight.copy_(torch.empty(c).uniform_(0.7, 1.3, generator=g))
            m.bias.copy_(torch.randn(c, generator=g) * 0.1)
        elif isinstance(m, LayerScale):
            m.gamma.copy_(torch.empty(m.gamma.shape).uniform_(0.2, 0.6,
                                                              generator=g))
        elif isinstance(m, nn.BatchNorm2d):
            randomize_batchnorm(m, g)
    vit = model.backbone
    for p in (vit.cls_token, vit.storage_tokens):
        p.copy_(torch.randn(p.shape, generator=g) * 0.5)
