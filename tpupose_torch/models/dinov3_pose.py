"""DINOv3Pose, the single-stage multi-instance pose model (counterpart of
tpupose/models/dinov3_pose.py): backbone stages at strides 8, 16, 32 ->
FeatureAdaptor to the neck widths -> SPPF on the deepest -> PAN ->
PoseHead.

Backbones: `dinov3_convnext_{size}` (models/backbones/convnext.py, its
last three stage maps) or `dinov3_vit_{size}` and the DINOv3 release
shorthands (`dinov3_vitb16`, ...; models/backbones/vit.DinoViT, the
outputs of blocks depth//3 - 1, 2 depth//3 - 1 and depth - 1, before the
final norm). The ViT's three token maps (H/16) are resized to H/8,
H/16 and H/32 as jax.image.resize's bilinear does: half-pixel centres,
antialiased where a side shrinks (the H/32 level; torch's plain bilinear
is 0.99 off there). On the card the ViT's attention is the flash kernel
K8 (ops/attention.fused_attention).

`forward(x)` takes normalized NHWC (B, H, W, 3) images; in training it
returns the raw per-scale NHWC maps, in eval mode the decoded (B, A,
[4 +] ncls + K * kpt_dim). `forward(x, return_features=True)` also
returns the backbone's deepest map, NHWC (the ViT's last block output
before the final norm, ConvNeXt's stride-32 stage), which the predictor
pools into appearance embeddings; JAX gets it by capture_intermediates.
`freeze_backbone` runs the backbone without recording a graph (JAX's
stop_gradient). The dtype policy is the other models': float32 master
weights under bf16 autocast where `dtype` and `param_dtype` differ.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.models.backbones.convnext import ConvNeXt
from tpupose_torch.models.backbones.vit import VIT_SIZES, DinoViT
from tpupose_torch.models.necks import PAN, SPPF, FeatureAdaptor, resize_to
from tpupose_torch.models.yolo_head import Float32Conv, PoseHead

_VIT_SHORTHAND = {
    "vits16": "small", "vits16plus": "small_plus", "vitb16": "base",
    "vitl16": "large", "vith16plus": "huge_plus", "vit7b16": "7b",
}


def _parse_backbone(name: str):
    """'dinov3_convnext_tiny' -> ('convnext', 'tiny'); also 'convnext_tiny',
    'vit_small' and the DINOv3 release shorthands ('dinov3_vits16')."""
    parts = name.split("_")
    if parts[0] == "dinov3":
        parts = parts[1:]
    if parts[0] in _VIT_SHORTHAND:
        return "vit", _VIT_SHORTHAND[parts[0]]
    family = parts[0]
    size = "_".join(parts[1:]) or ("tiny" if family == "convnext" else "small")
    if family not in ("convnext", "vit"):
        raise ValueError(f"unknown backbone family in {name!r}")
    return family, size


def vit_level_ids(depth: int):
    """The ViT blocks whose outputs feed the three pyramid levels."""
    return (depth // 3 - 1, 2 * depth // 3 - 1, depth - 1)


class DINOv3Pose(nn.Module):
    def __init__(self, backbone: str = "dinov3_convnext_tiny",
                 num_keypoints: int = 4, num_classes: int = 7,
                 neck_channels: Sequence[int] = (192, 384, 768),
                 strides: Sequence[int] = (8, 16, 32),
                 freeze_backbone: bool = True, kpt_dim: int = 3,
                 reg_max: int = 0, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.backbone_name = backbone
        self.family, size = _parse_backbone(backbone)
        self.num_keypoints = num_keypoints
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.freeze_backbone = freeze_backbone
        self.reg_max = reg_max
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        if self.family == "convnext":
            self.backbone = ConvNeXt.from_size(size, remat=remat)
            in_ch = self.backbone.dims[1:]
        else:
            depth = VIT_SIZES[size]["depth"]
            self.level_ids = vit_level_ids(depth)
            self.backbone = DinoViT.from_size(
                size, intermediates=self.level_ids, remat=remat)
            in_ch = (self.backbone.dim,) * 3
        nc = tuple(neck_channels)
        self.adaptor = FeatureAdaptor(in_ch, nc)
        self.sppf = SPPF(nc[-1], nc[-1])
        self.pan = PAN(nc)
        self.head = PoseHead(nc, num_classes, (num_keypoints, kpt_dim),
                             self.strides, reg_max)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        for m in self.head.modules():
            if isinstance(m, Float32Conv):
                m.float()
        self.eval()

    def _backbone(self, x):
        """NHWC images -> (three NCHW levels at strides 8/16/32, the deepest
        backbone map NHWC)."""
        if self.family == "convnext":
            feats = self.backbone(x.permute(0, 3, 1, 2))
            return feats[1:], feats[-1].permute(0, 2, 3, 1)
        B, H, W, _ = x.shape
        inter = self.backbone(x)["intermediates"]
        lvls = [resize_to(inter[i].permute(0, 3, 1, 2), (H // s, W // s))
                for i, s in zip(self.level_ids, self.strides)]
        return lvls, inter[self.level_ids[-1]]

    def _forward(self, x, return_features):
        if self.freeze_backbone:
            with torch.no_grad():
                feats, deepest = self._backbone(x)
        else:
            feats, deepest = self._backbone(x)
        feats = self.adaptor(feats)
        feats[-1] = self.sppf(feats[-1])
        out = self.head(self.pan(feats))
        return (out, deepest) if return_features else out

    def _autocast(self, x):
        """(input, context): bf16 autocast over float32 masters, or the
        input cast to the parameters' dtype."""
        if self.compute_dtype == self.param_dtype:
            return x.to(self.param_dtype), contextlib.nullcontext()
        return x, torch.autocast(x.device.type, dtype=self.compute_dtype)

    def forward(self, x, return_features: bool = False):
        x, ctx = self._autocast(x)
        with ctx:
            return self._forward(x, return_features)

    @torch.no_grad()
    def forward_features(self, x):
        """Backbone features only: ConvNeXt's four stage maps, or the ViT's
        three level-block outputs (before resizing), each NHWC."""
        x, ctx = self._autocast(x)
        with ctx:
            if self.family == "convnext":
                return [f.permute(0, 2, 3, 1)
                        for f in self.backbone(x.permute(0, 3, 1, 2))]
            inter = self.backbone(x)["intermediates"]
            return [inter[i] for i in self.level_ids]


@torch.no_grad()
def init_dinov3_pose_like_flax(model: DINOv3Pose, g: torch.Generator):
    """flax's initializers drawn from `g` on the CPU (the init of
    tpupose's DINOv3Pose): lecun_normal conv and dense kernels, zero
    biases, unit norm scales; the ViT's tokens truncated_normal(0.02) and
    layer scales 1e-5, ConvNeXt's layer scales 1e-6 and GRN zeros; the
    class convs' bias -log(99)."""
    from tpupose_torch.models.necks import ConvNeXtBlock
    from tpupose_torch.models.simple_baseline import init_like_flax
    from tpupose_torch.models.vitpose import init_vit_like_flax
    from tpupose_torch.models.yolo_head import PRIOR_BIAS

    init_like_flax(model, g)
    if model.family == "vit":
        init_vit_like_flax(model.backbone, g)
    for m in model.modules():
        if isinstance(m, ConvNeXtBlock) and m.gamma is not None:
            m.gamma.fill_(1e-6)
    for br in model.head.cls:
        br.out.bias.fill_(PRIOR_BIAS)
