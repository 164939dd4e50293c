"""Neck building blocks (counterpart of tpupose/models/necks.py):
ConvBlock, Bottleneck, BottleneckCSP, SPPF, PAN, FeatureAdaptor,
AttentionBlock and the ConvNeXt block with GRN and DropPath.

Every module here takes and returns NCHW tensors (the models keep them in
`channels_last` memory format, NHWC in memory). Where the port must not
differ from flax:
  - ConvBlock's BatchNorm has epsilon 1e-3 (torch's default is 1e-5) and
    torch momentum 0.1 (flax momentum 0.9), with flax's train-mode
    statistics update (models/backbones/resnet.BatchNorm2d); SiLU;
    symmetric padding kernel // 2, also at stride 2;
  - SPPF's max-pools pad with -inf (F.max_pool2d's implicit padding);
  - PAN's fuses resize with jax.image.resize's bilinear, which for an
    upsample equals F.interpolate(bilinear, align_corners=False), edges
    included;
  - the ConvNeXt block's LayerNorm is over channels with epsilon 1e-6 and
    its GELU is the tanh form (flax.linen.gelu's default).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpupose_torch.models.attention import Attention
from tpupose_torch.models.backbones.resnet import BatchNorm2d

LN_EPS = 1e-6


class ConvBlock(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + SiLU."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = BatchNorm2d(c_out, eps=1e-3, momentum=0.1)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two ConvBlocks (1x1, 3x3) with a residual where the widths agree."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(c_out * expansion)
        self.cv1 = ConvBlock(c_in, hidden, 1)
        self.cv2 = ConvBlock(hidden, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class BottleneckCSP(nn.Module):
    """CSP stack: two 1x1 branches, `n` Bottlenecks on the first, concat,
    1x1 to `c_out`."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5):
        super().__init__()
        hidden = int(c_out * expansion)
        self.cv1 = ConvBlock(c_in, hidden, 1)
        self.cv2 = ConvBlock(c_in, hidden, 1)
        self.m = nn.Sequential(*(Bottleneck(hidden, hidden, shortcut, 1.0)
                                 for _ in range(n)))
        self.cv3 = ConvBlock(2 * hidden, c_out, 1)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: 1x1 to half the width, three chained
    5x5/1 max-pools (-inf padding), concat, 1x1 to `c_out`."""

    def __init__(self, c_in: int, c_out: int, pool_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.cv1 = ConvBlock(c_in, hidden, 1)
        self.cv2 = ConvBlock(4 * hidden, c_out, 1)
        self.pool = pool_size

    def forward(self, x):
        x = self.cv1(x)
        p = self.pool
        ys = [x]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], p, 1, p // 2))
        return self.cv2(torch.cat(ys, 1))


def resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear NCHW resize to `hw`, as jax.image.resize(..., "bilinear"):
    half-pixel centres, and antialiased where a side shrinks (JAX widens
    its triangle kernel by the scale there; torch's `antialias=True` does
    the same). The identity size returns `x`."""
    h, w = int(hw[0]), int(hw[1])
    if (h, w) == tuple(x.shape[2:]):
        return x
    shrink = h < x.shape[2] or w < x.shape[3]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrink)


class PAN(nn.Module):
    """Path aggregation over [P3, P4, P5] (fine -> coarse): FPN top-down
    then bottom-up, a bilinear resize at each top-down fuse."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        c3, c4, c5 = channels
        self.reduce4 = ConvBlock(c4 + c5, c4, 1)
        self.csp4 = BottleneckCSP(c4, c4, 1, shortcut=False)
        self.reduce3 = ConvBlock(c3 + c4, c3, 1)
        self.csp3 = BottleneckCSP(c3, c3, 1, shortcut=False)
        self.down4 = ConvBlock(c3, c3, 3, 2)
        self.out4 = BottleneckCSP(c3 + c4, c4, 1, shortcut=False)
        self.down5 = ConvBlock(c4, c4, 3, 2)
        self.out5 = BottleneckCSP(c4 + c5, c5, 1, shortcut=False)

    def forward(self, feats):
        p3, p4, p5 = feats
        t4 = self.csp4(self.reduce4(torch.cat(
            [p4, resize_to(p5, p4.shape[2:])], 1)))
        t3 = self.csp3(self.reduce3(torch.cat(
            [p3, resize_to(t4, p3.shape[2:])], 1)))
        o4 = self.out4(torch.cat([self.down4(t3), t4], 1))
        o5 = self.out5(torch.cat([self.down5(o4), p5], 1))
        return [t3, o4, o5]


class FeatureAdaptor(nn.Module):
    """Per level a 1x1 then a 3x3 ConvBlock to the neck's width."""

    def __init__(self, in_channels: Sequence[int], channels: Sequence[int]):
        super().__init__()
        self.levels = nn.ModuleList(
            nn.Sequential(ConvBlock(ci, c, 1), ConvBlock(c, c, 3))
            for ci, c in zip(in_channels, channels))

    def forward(self, feats):
        return [lvl(f) for lvl, f in zip(self.levels, feats)]


class AttentionBlock(nn.Module):
    """Transformer block over a feature map: the (H*W) tokens, row-major,
    through pre-LayerNorm (epsilon 1e-6) MHSA (models/attention.Attention)
    and a GELU (tanh) MLP, each with a residual, back to the map."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        B, C, H, W = x.shape
        t = x.flatten(2).transpose(1, 2)                     # (B, H*W, C)
        t = t + self.attn(self.norm1(t))
        t = t + self.fc2(F.gelu(self.fc1(self.norm2(t)), approximate="tanh"))
        return t.transpose(1, 2).reshape(B, C, H, W)


class DropPath(nn.Module):
    """Stochastic depth: in training each sample's branch is dropped with
    probability `rate` (kept ones scaled by 1 / (1 - rate)); identity in
    eval mode. The draws are torch's, not JAX's."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.bernoulli(torch.full(shape, keep, device=x.device))
        return x / keep * mask.to(x.dtype)


class GRN(nn.Module):
    """Global response normalization (ConvNeXtV2) over NHWC activations:
    the per-channel spatial L2 norm (float32) over its channel mean."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        gx = torch.sqrt((x.float() ** 2).sum(dim=(1, 2), keepdim=True)
                        + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (x * nx.to(x.dtype)) + self.beta
                + x).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LayerNorm -> Linear x4 -> GELU (tanh) -> (GRN) ->
    Linear -> layer scale `gamma` -> DropPath, plus the input. v2 adds
    GRN and drops the layer scale."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6, v2: bool = False):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim) if v2 else None
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init))
                      if not v2 and layer_scale_init > 0 else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)              # NHWC
        y = F.gelu(self.pwconv1(self.norm(y)), approximate="tanh")
        if self.grn is not None:
            y = self.grn(y)
        y = self.pwconv2(y)
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y.permute(0, 3, 1, 2))
