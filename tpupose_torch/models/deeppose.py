"""DeepPose: direct coordinate regression, and its RLE variant
(counterpart of tpupose/models/deeppose.py).

A ResNet backbone, GAP and a linear layer to (B, K, 2) normalized
coordinates (heads.RegressionHead). With `rle=True` the linear layer
(`rle_head`, zero-initialised) predicts (mu, sigma) per joint, sigma
through a sigmoid, and a RealNVP flow (losses/rle.py) models the residual
density: `forward(x)` returns (mu, sigma), `forward(x, target)` also the
flow's log-density of the sigma-normalized error. The flow always belongs
to the module (flax registers it on a forward-only trace).
"""

from __future__ import annotations

import torch
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.losses.rle import RealNVP
from tpupose_torch.models.backbones.resnet import ResNet
from tpupose_torch.models.heads import RegressionHead
from tpupose_torch.models.simple_baseline import (_init_from_generator,
                                                  autocast_call,
                                                  init_like_flax)


class DeepPose(nn.Module):
    """NHWC (B, H, W, 3) normalized images -> (B, K, 2) coordinates in
    [0, 1] (x, y); with `rle`, (mu, sigma[, log_phi]).

    The dtype policy is SimpleBaseline's: built on `device` (default
    "cuda"; raises if CUDA is absent), parameters in `channels_last` and
    in `param_dtype` (default `dtype`); float32 masters with
    `dtype=bfloat16` run the backbone under bf16 autocast. The linear
    layers and the flow run in float32 outside autocast (flax's
    Dense(..., dtype=float32))."""

    def __init__(self, backbone: str = "resnet50", num_keypoints: int = 17,
                 rle: bool = False, flow_layers: int = 3,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.backbone_name = backbone
        self.num_keypoints = num_keypoints
        self.rle = rle
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.backbone = ResNet.from_name(backbone, remat)
        c = self.backbone.out_channels
        if rle:
            self.rle_head = nn.Linear(c, 4 * num_keypoints)
            self.flow = RealNVP(layers=flow_layers)
            _zero_init(self)
            fp32 = (self.rle_head, self.flow)
        else:
            self.head = RegressionHead(c, num_keypoints)
            fp32 = (self.head.fc,)
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        for m in fp32:
            m.float()
        self.eval()

    def forward(self, x, target=None):
        x = x.permute(0, 3, 1, 2)
        f = autocast_call(self, self.backbone, x)
        if not self.rle:
            return self.head(f)
        B, K = x.shape[0], self.num_keypoints
        f = f.mean(dim=(2, 3))
        with torch.autocast(x.device.type, enabled=False):
            out = self.rle_head(f.float())
        mu = out[:, :2 * K].reshape(B, K, 2)
        # sigma in (0, 1): the coordinates are normalized
        sigma = torch.sigmoid(out[:, 2 * K:]).reshape(B, K, 2)
        if target is None:
            return mu, sigma
        error = (target.float() - mu) / (sigma + 1e-9)
        log_phi = self.flow(error.reshape(B * K, 2)).reshape(B, K)
        return mu, sigma, log_phi


@torch.no_grad()
def _zero_init(model: DeepPose):
    """flax's zero kernels: the RLE head (mu starts at 0 and sigma at
    sigmoid(0) = 0.5, so the first NLL is O(1)) and each coupling's
    scale and shift layers (the flow starts as the identity)."""
    model.rle_head.weight.zero_()
    model.rle_head.bias.zero_()
    for c in model.flow.couplings:
        for lin in c.layers[2:]:
            lin.weight.zero_()
            lin.bias.zero_()


@torch.no_grad()
def init_deeppose_like_flax(model: DeepPose, g: torch.Generator):
    """tpupose's DeepPose init: flax's default initialisers
    (simple_baseline.init_like_flax) drawn from `g`, the zero kernels
    kept zero."""
    init_like_flax(model, g)
    if model.rle:
        _zero_init(model)
