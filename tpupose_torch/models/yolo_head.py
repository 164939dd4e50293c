"""YOLO-style heads (counterpart of tpupose/models/yolo_head.py:
make_anchors, dist2bbox, dfl_integral / DFL, PoseHead, DetectHead).

PoseHead takes the neck's NCHW maps (fine -> coarse). In training it
returns the raw per-scale maps, NHWC (B, H, W, [4 * reg_max +] ncls +
K * kpt_dim) as JAX does; in eval mode the decoded (B, A, [4 +] ncls +
K * kpt_dim): boxes in input pixels (xywh) when reg_max > 0, class
sigmoids, keypoint xy in input pixels, visibility sigmoids. Each branch's
last 1x1 conv runs in float32 (autocast off, input cast), as the flax
head's `dtype=float32` convs do; the class conv's bias starts at the
prior-probability value -log(99).

Decode conventions: reg_max = 0 (the box-free head) puts a keypoint at
(v - 0.5 + anchor) * stride; reg_max > 0 adds the DFL box branch and the
v8 convention (2v + anchor - 0.5) * stride.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from tpupose_torch.models.necks import ConvBlock

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def make_anchors(shapes, strides, grid_cell_offset: float = 0.5,
                 device=None):
    """Anchor centres in grid units (A, 2) and each anchor's stride (A,)
    for per-scale grids `shapes` [(H, W), ...], x fastest."""
    pts, sts = [], []
    for (h, w), s in zip(shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) \
            + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) \
            + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        sts.append(torch.full((h * w,), float(s), dtype=torch.float32,
                              device=device))
    return torch.cat(pts), torch.cat(sts)


def dist2bbox(distance, anchor_points, xywh: bool = True):
    """ltrb distances + anchor centres -> boxes (xywh or xyxy)."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def dfl_integral(x, reg_max: int = 16):
    """Distribution focal loss integral: (B, A, 4 * reg_max) logits ->
    (B, A, 4) expected bin, softmax in float32."""
    B, A, _ = x.shape
    p = torch.softmax(x.reshape(B, A, 4, reg_max).float(), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (p * bins).sum(-1)


class DFL(nn.Module):
    """Module wrapper over dfl_integral (no parameters)."""

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.reg_max = reg_max

    def forward(self, x):
        return dfl_integral(x, self.reg_max)


class Float32Conv(nn.Conv2d):
    """A 1x1 conv that computes in float32 whatever the autocast state."""

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.to(self.weight.dtype))


class _ClsBranch(nn.Module):
    """cv3: 3x3 (input width) -> 1x1 -> 3x3 -> 1x1 ConvBlocks, then a
    float32 1x1 conv to ncls with the prior-probability bias."""

    def __init__(self, c_in: int, ncls: int, mid: int):
        super().__init__()
        self.blocks = nn.Sequential(ConvBlock(c_in, c_in, 3),
                                    ConvBlock(c_in, mid, 1),
                                    ConvBlock(mid, mid, 3),
                                    ConvBlock(mid, mid, 1))
        self.out = Float32Conv(mid, ncls, 1)
        nn.init.constant_(self.out.bias, PRIOR_BIAS)

    def forward(self, x):
        return self.out(self.blocks(x))


class _Branch(nn.Module):
    """Two 3x3 ConvBlocks, then a float32 1x1 conv: cv4 (to K * kpt_dim)
    and the DFL box branch (to 4 * reg_max, reg_max > 0)."""

    def __init__(self, c_in: int, c_out: int, mid: int):
        super().__init__()
        self.blocks = nn.Sequential(ConvBlock(c_in, mid, 3),
                                    ConvBlock(mid, mid, 3))
        self.out = Float32Conv(mid, c_out, 1)

    def forward(self, x):
        return self.out(self.blocks(x))


class PoseHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 1,
                 kpt_shape=(17, 3), strides=(8, 16, 32), reg_max: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.kpt_shape = tuple(kpt_shape)
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.box_ch = 4 * reg_max
        c0 = in_channels[0]
        c2 = max(16, c0 // 4, self.box_ch)
        c3 = max(c0, min(num_classes, 100))
        c4 = max(c0 // 4, self.nk)
        self.box = (nn.ModuleList(_Branch(c, self.box_ch, c2)
                                  for c in in_channels)
                    if reg_max > 0 else None)
        self.cls = nn.ModuleList(_ClsBranch(c, num_classes, c3)
                                 for c in in_channels)
        self.kpt = nn.ModuleList(_Branch(c, self.nk, c4)
                                 for c in in_channels)

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            parts = [self.box[i](f)] if self.box is not None else []
            parts += [self.cls[i](f), self.kpt[i](f)]
            outs.append(torch.cat(parts, 1).permute(0, 2, 3, 1))  # NHWC
        if self.training:
            return outs
        return self.decode(outs)

    def decode(self, outs):
        """Per-scale NHWC raw maps -> (B, A, [4 +] ncls + nk) float32."""
        shapes = [tuple(o.shape[1:3]) for o in outs]
        dev = outs[0].device
        anchors, strides = make_anchors(shapes, self.strides, device=dev)
        B = outs[0].shape[0]
        C = self.box_ch + self.num_classes + self.nk
        flat = torch.cat([o.reshape(B, -1, C) for o in outs], 1).float()
        nc, bc = self.num_classes, self.box_ch
        cls = torch.sigmoid(flat[..., bc:bc + nc])
        K, ndim = self.kpt_shape
        kpt = flat[..., bc + nc:].reshape(B, -1, K, ndim)
        a = anchors[None, :, None, :]
        s = strides[None, :, None, None]
        if self.reg_max > 0:
            dist = dfl_integral(flat[..., :bc], self.reg_max)
            boxes = dist2bbox(dist, anchors[None]) * strides[None, :, None]
            xy = (2.0 * kpt[..., :2] + (a - 0.5)) * s
        else:
            boxes = None
            xy = (kpt[..., :2] - 0.5 + a) * s
        if ndim == 3:
            kpt = torch.cat([xy, torch.sigmoid(kpt[..., 2:3])], dim=-1)
        else:
            kpt = xy
        pieces = ([boxes] if boxes is not None else []) \
            + [cls, kpt.reshape(B, -1, self.nk)]
        return torch.cat(pieces, dim=-1)


class DetectHead(nn.Module):
    """YOLO detect head with the DFL box branch: per level a box branch
    (two 3x3 ConvBlocks to c2, a float32 1x1 conv to 4 * reg_max, plus one
    objectness channel with `objectness`) and a class branch (two 3x3
    ConvBlocks to c3, a float32 1x1 conv to ncls with the prior bias).
    Training returns the raw per-scale NHWC maps (B, H, W, box_ch + ncls);
    eval mode the decoded (B, A, 4 + ncls): DFL boxes (xywh, input
    pixels) and class sigmoids, times the objectness sigmoid with
    `objectness` (the head3 variant)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 reg_max: int = 16, strides=(8, 16, 32),
                 objectness: bool = False):
        super().__init__()
        self.num_classes, self.reg_max = num_classes, reg_max
        self.strides = tuple(strides)
        self.objectness = objectness
        self.box_ch = 4 * reg_max + (1 if objectness else 0)
        c0 = in_channels[0]
        c2 = max(16, c0 // 4, reg_max * 4)
        c3 = max(c0, min(num_classes, 100))
        self.box = nn.ModuleList(_Branch(c, self.box_ch, c2)
                                 for c in in_channels)
        self.cls = nn.ModuleList(_Branch(c, num_classes, c3)
                                 for c in in_channels)
        for br in self.cls:
            nn.init.constant_(br.out.bias, PRIOR_BIAS)

    def forward(self, feats):
        outs = [torch.cat([self.box[i](f), self.cls[i](f)], 1)
                .permute(0, 2, 3, 1) for i, f in enumerate(feats)]
        if self.training:
            return outs
        return self.decode(outs)

    def decode(self, outs):
        """Per-scale NHWC raw maps -> (B, A, 4 + ncls) float32."""
        shapes = [tuple(o.shape[1:3]) for o in outs]
        anchors, strides = make_anchors(shapes, self.strides,
                                        device=outs[0].device)
        B = outs[0].shape[0]
        C = self.box_ch + self.num_classes
        flat = torch.cat([o.reshape(B, -1, C) for o in outs], 1).float()
        nb = 4 * self.reg_max
        dist = dfl_integral(flat[..., :nb], self.reg_max)
        boxes = dist2bbox(dist, anchors[None]) * strides[None, :, None]
        cls = torch.sigmoid(flat[..., self.box_ch:])
        if self.objectness:
            cls = cls * torch.sigmoid(flat[..., nb:self.box_ch])
        return torch.cat([boxes, cls], dim=-1)
