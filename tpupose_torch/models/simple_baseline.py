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

    Built on `device` (default "cuda"; raises if CUDA is absent) with
    every parameter in `channels_last` memory format and in
    `param_dtype`, which defaults to `dtype` (the serving build: the model
    is cast to its compute dtype). For training, `param_dtype=float32`
    with `dtype=bfloat16` keeps float32 master weights and runs the
    forward under torch.autocast in bf16, as the flax model with
    `dtype=bf16` and float32 params does. Either way the head's final
    1x1 conv runs in float32. Weights come from the module initializers
    under `generator` (seeded when given), from `init_like_flax`, or from
    a state dict (see tpupose_torch.utils.convert). `remat` checkpoints
    each residual block in training (models/remat.py)."""

    def __init__(self, backbone: str = "resnet50", num_keypoints: int = 17,
                 deconv_channels: Sequence[int] = (256, 256, 256),
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.backbone_name = backbone
        self.num_keypoints = num_keypoints
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.backbone = ResNet.from_name(backbone, remat)
        self.head = HeatmapHead(self.backbone.out_channels, num_keypoints,
                                deconv_channels)
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        self.head.final_layer.float()
        self.eval()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.compute_dtype == self.param_dtype:
            y = self.head(self.backbone(x.to(self.param_dtype)))
        else:
            with torch.autocast(x.device.type, dtype=self.compute_dtype):
                y = self.head(self.backbone(x))
        return y.permute(0, 2, 3, 1)


def autocast_call(model: nn.Module, fn, x):
    """fn(x) under the model's dtype policy: x cast to the parameters'
    dtype where the model computes in it, else under torch.autocast to
    `model.compute_dtype` (float32 masters computing in bf16)."""
    if model.compute_dtype == model.param_dtype:
        return fn(x.to(model.param_dtype))
    with torch.autocast(x.device.type, dtype=model.compute_dtype):
        return fn(x)


@torch.no_grad()
def init_like_flax(model: nn.Module, g: torch.Generator):
    """flax's default initialisers, drawn from `g` on the CPU: every conv,
    deconv and dense kernel lecun_normal (a normal truncated at 2 std,
    scaled to variance 1/fan_in), zero biases, BatchNorm and LayerNorm
    scale 1, bias 0, running mean 0 and variance 1 (the init of tpupose's
    SimpleBaseline)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel() \
                if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()


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
            randomize_batchnorm(m, g)


@torch.no_grad()
def randomize_batchnorm(m: nn.BatchNorm2d, g: torch.Generator):
    """Scale U(0.5, 1), bias N(0, 0.1), running mean N(0, 0.1) and
    variance U(0.5, 2), drawn from `g` in that order."""
    c = m.num_features
    m.weight.copy_(torch.empty(c).uniform_(0.5, 1.0, generator=g))
    m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
    m.running_var.copy_(torch.empty(c).uniform_(0.5, 2.0, generator=g))
