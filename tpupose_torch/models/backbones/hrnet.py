"""HRNet-W32/W48 multi-resolution backbone and its pose model in PyTorch
(counterpart of tpupose/models/backbones/hrnet.py; graded configs
BASELINE.json:9-10).

A stride-4 stem of two 3x3/2 convs, a stage of four Bottlenecks, then
three multi-branch stages whose modules exchange information through
fuse layers; the 1x1 heatmap head runs on the highest-resolution branch.
Names are the port's own (`backbone.stem.0.conv`, `backbone.stage2.
branches.0.1.blocks.3.conv1`, `backbone.stage2.fuse.0.paths.0_1.conv`,
`final_layer`); `tpupose_torch.utils.convert.from_flax_hrnet` maps the
flax tree onto them. The head is not under `backbone.`, so the head/base
lr split and `freeze_backbone` act on it as JAX's `HRNet_0/*` rule does.

The fuse layers upsample by nearest neighbour to the target branch's
size. At an integer ratio that is a plain repeat; at a non-integer one
(a 2x2 branch against a 4x3 one at 64x48 input) JAX's
`jax.image.resize(..., "nearest")` takes the source pixel
floor((d + 0.5) * in / out), which is torch's "nearest-exact" (torch's
"nearest" takes floor(d * in / out) and differs).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch._device import resolve_device
from tpupose_torch.models.backbones.resnet import BasicBlock, Bottleneck, _bn
from tpupose_torch.models.remat import block_call


def _upsample_to(x, hw):
    """Nearest upsample of NCHW `x` to spatial size `hw` (JAX's rule at
    any ratio)."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class _ConvBN(nn.Module):
    """conv (k x k, stride s, padding k // 2, no bias) + BatchNorm [+ ReLU]."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = _bn(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class _Branch(nn.Module):
    """num_blocks BasicBlocks at constant width."""

    def __init__(self, width: int, num_blocks: int = 4):
        super().__init__()
        self.blocks = nn.Sequential(*[BasicBlock(width, width)
                                      for _ in range(num_blocks)])

    def forward(self, x):
        return self.blocks(x)


class _FuseLayer(nn.Module):
    """Every output branch i sums every input branch j: a 1x1 conv + BN
    and a nearest upsample from a lower resolution (j > i), a chain of
    i - j stride-2 3x3 conv + BN from a higher one (j < i, ReLU between
    the steps, none after the last), then ReLU. `paths["i_j"]` holds the
    transform of j into i."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        self.n = len(widths)
        paths = {}
        for i in range(self.n):
            for j in range(self.n):
                if j > i:
                    paths[f"{i}_{j}"] = _ConvBN(widths[j], widths[i], 1,
                                                relu=False)
                elif j < i:
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        steps.append(_ConvBN(
                            widths[j], widths[i] if last else widths[j], 3,
                            stride=2, relu=not last))
                    paths[f"{i}_{j}"] = nn.Sequential(*steps)
        self.paths = nn.ModuleDict(paths)

    def forward(self, xs):
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = xs[j]
                if j > i:
                    y = _upsample_to(self.paths[f"{i}_{j}"](y),
                                     xs[i].shape[-2:])
                elif j < i:
                    y = self.paths[f"{i}_{j}"](y)
                acc = y if acc is None else acc + y
            outs.append(torch.relu(acc))
        return outs


class _Stage(nn.Module):
    """num_modules x (branches + fuse); `remat` checkpoints each branch."""

    def __init__(self, widths: Sequence[int], num_modules: int,
                 num_blocks: int = 4, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.branches = nn.ModuleList([
            nn.ModuleList([_Branch(w, num_blocks) for w in widths])
            for _ in range(num_modules)])
        self.fuse = nn.ModuleList([_FuseLayer(widths)
                                   for _ in range(num_modules)])

    def forward(self, xs):
        for branches, fuse in zip(self.branches, self.fuse):
            xs = [block_call(br, x, self.remat)
                  for br, x in zip(branches, xs)]
            xs = fuse(xs)
        return xs


HRNET_SPECS = {
    "hrnet_w32": {"width": 32, "modules": (1, 4, 3)},
    "hrnet_w48": {"width": 48, "modules": (1, 4, 3)},
    "hrnet_w18": {"width": 18, "modules": (1, 4, 3)},
}


class HRNet(nn.Module):
    """HRNet backbone: NCHW in, the stride-4 high-resolution map out.
    `remat` checkpoints each stage-1 Bottleneck and each branch."""

    def __init__(self, width: int = 32, modules: Sequence[int] = (1, 4, 3),
                 remat: bool = False):
        super().__init__()
        w = width
        self.width = width
        self.remat = remat
        self.stem = nn.Sequential(_ConvBN(3, 64, 3, 2), _ConvBN(64, 64, 3, 2))
        self.layer1 = nn.Sequential(*[Bottleneck(64 if n == 0 else 256, 64)
                                      for n in range(4)])
        self.transition1 = nn.ModuleList([_ConvBN(256, w, 3),
                                          _ConvBN(256, 2 * w, 3, 2)])
        self.stage2 = _Stage((w, 2 * w), modules[0], remat=remat)
        self.transition2 = _ConvBN(2 * w, 4 * w, 3, 2)
        self.stage3 = _Stage((w, 2 * w, 4 * w), modules[1], remat=remat)
        self.transition3 = _ConvBN(4 * w, 8 * w, 3, 2)
        self.stage4 = _Stage((w, 2 * w, 4 * w, 8 * w), modules[2],
                             remat=remat)
        self.out_channels = w

    @classmethod
    def from_name(cls, name: str, remat: bool = False) -> "HRNet":
        if name not in HRNET_SPECS:
            raise ValueError(f"unknown hrnet {name!r}; have "
                             f"{sorted(HRNET_SPECS)}")
        s = HRNET_SPECS[name]
        return cls(s["width"], s["modules"], remat)

    def forward(self, x):
        x = self.stem(x)
        for blk in self.layer1:
            x = block_call(blk, x, self.remat)
        xs = [t(x) for t in self.transition1]
        xs = self.stage2(xs)
        xs = self.stage3(xs + [self.transition2(xs[-1])])
        xs = self.stage4(xs + [self.transition3(xs[-1])])
        return xs[0]


class HRNetPose(nn.Module):
    """HRNet + a 1x1 heatmap conv: NHWC (B, H, W, 3) normalized images ->
    heatmaps (B, H/4, W/4, K), no deconvs.

    The dtype policy is SimpleBaseline's: built on `device` (default
    "cuda"; raises if CUDA is absent), parameters in `channels_last` and
    in `param_dtype` (default `dtype`); float32 masters with
    `dtype=bfloat16` run the backbone under bf16 autocast. The head conv
    runs in float32 outside autocast (flax's `nn.Conv(...,
    dtype=float32)`). Weights from `generator` (seeded He-normal convs and
    non-trivial BatchNorm statistics), `init_like_flax`, or a state dict
    (`from_flax_hrnet`)."""

    def __init__(self, variant: str = "hrnet_w32", num_keypoints: int = 17,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 generator: torch.Generator | None = None,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        from tpupose_torch.models.simple_baseline import _init_from_generator

        super().__init__()
        dev = resolve_device(device)
        self.backbone_name = variant
        self.num_keypoints = num_keypoints
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.backbone = HRNet.from_name(variant, remat)
        self.final_layer = nn.Conv2d(self.backbone.out_channels,
                                     num_keypoints, 1)
        if generator is not None:
            _init_from_generator(self, generator)
        self.to(device=dev, dtype=self.param_dtype,
                memory_format=torch.channels_last)
        self.final_layer.float()
        self.eval()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.compute_dtype == self.param_dtype:
            f = self.backbone(x.to(self.param_dtype))
        else:
            with torch.autocast(x.device.type, dtype=self.compute_dtype):
                f = self.backbone(x)
        with torch.autocast(x.device.type, enabled=False):
            y = self.final_layer(f.to(self.final_layer.weight.dtype))
        return y.permute(0, 2, 3, 1)
