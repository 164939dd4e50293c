"""GaussianPooling and MetaSpace: an EMA memory of per-keypoint features
(counterpart of tpupose/models/meta.py).

`gaussian_pool` is a dense gather over a fixed 5x5 offset grid around
each keypoint's clamped, rounded position (torch.round rounds half to
even, as jnp.round does). Out-of-bounds taps are dropped from the weight
sum; a keypoint whose taps all fall out of bounds takes its clamped
centre pixel; invisible keypoints (vis <= 0) pool to zero.

`MetaSpace` keeps flax's "meta_space" collection as three buffers,
`meta_features` (L, K, D), `feature_sum` (L, K, D) and `feature_count`
(L, K), which checkpoint with the module. The forward pools each level's
features at the keypoints, fuses them with the level's memory (one
GatedAttention `fusers.i` a level, then `proj`) and, with `accumulate`,
adds the pooled features of visible keypoints to the running sums (no
gradient, as flax's mutable collection takes none). torch has no
initialising pass, so there is no first call to skip, as flax's
`is_initializing` does. `update_meta_spaces` merges the accumulated means
into the memory with momentum 0.9 (a keypoint's first write adopts the
mean) and resets the accumulators.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpupose_torch.models.attention import GatedAttention


def gaussian_pool(feat, kpts, vis, window: int = 5, sigma: float = 2.0):
    """Gaussian-weighted patch pooling. feat (B, H, W, C); kpts (B, K, 2)
    in feature pixels (x, y); vis (B, K). Returns (B, K, C) in feat's
    dtype."""
    B, H, W, C = feat.shape
    K = kpts.shape[1]
    half = window // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=feat.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")       # (w, w)
    w2 = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * sigma * sigma))

    cx = torch.clamp(torch.round(kpts[..., 0].float()), 0, W - 1)  # (B, K)
    cy = torch.clamp(torch.round(kpts[..., 1].float()), 0, H - 1)
    gx = cx[..., None, None] + ox                            # (B, K, w, w)
    gy = cy[..., None, None] + oy
    inb = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H)
    gxc = torch.clamp(gx, 0, W - 1).long()
    gyc = torch.clamp(gy, 0, H - 1).long()

    flat = feat.reshape(B, H * W, C)
    idx = (gyc * W + gxc).reshape(B, K * window * window, 1)
    vals = torch.gather(flat, 1, idx.expand(-1, -1, C))
    vals = vals.reshape(B, K, window, window, C)

    wts = w2 * inb.float()                                   # (B, K, w, w)
    denom = wts.sum((-1, -2))                                # (B, K)
    pooled = (vals * wts[..., None].to(vals.dtype)).sum((2, 3))
    cidx = (cy * W + cx).long()[..., None].expand(-1, -1, C)
    center = torch.gather(flat, 1, cidx)
    pooled = torch.where(
        (denom > 0)[..., None],
        pooled / torch.clamp_min(denom, 1e-9)[..., None].to(pooled.dtype),
        center)
    return pooled * (vis > 0)[..., None].to(pooled.dtype)


class MetaSpace(nn.Module):
    """EMA per-keypoint feature memory over `num_levels` pyramid levels."""

    def __init__(self, num_keypoints: int, dim: int, num_levels: int = 3,
                 momentum: float = 0.9, num_heads: int = 4):
        super().__init__()
        L, K, D = num_levels, num_keypoints, dim
        self.momentum = momentum
        self.register_buffer("meta_features", torch.zeros(L, K, D))
        self.register_buffer("feature_sum", torch.zeros(L, K, D))
        self.register_buffer("feature_count", torch.zeros(L, K))
        self.fusers = nn.ModuleList(GatedAttention(dim, num_heads)
                                    for _ in range(num_levels))
        self.proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def accumulate_features(self, feats: Sequence, kpts_per_level, vis):
        """Add each level's pooled features of visible keypoints to the
        running sums, and their count."""
        for i, (f, kp) in enumerate(zip(feats, kpts_per_level)):
            self._accumulate(i, gaussian_pool(f, kp, vis), vis)

    def _accumulate(self, level: int, pooled, vis):
        m = (vis > 0).float()
        self.feature_sum[level] += (pooled * m[..., None].to(pooled.dtype)) \
            .sum(0).float()
        self.feature_count[level] += m.sum(0)

    @torch.no_grad()
    def update_meta_spaces(self):
        """EMA-merge the accumulated means into the memory, then zero the
        accumulators."""
        mem = self.meta_features.float()
        cnt = self.feature_count.float()[..., None]
        mean = self.feature_sum.float() / torch.clamp_min(cnt, 1e-9)
        has = cnt > 0
        new = torch.where(has, self.momentum * mem
                          + (1 - self.momentum) * mean, mem)
        first = has & (mem.abs().sum(-1, keepdim=True) == 0)
        self.meta_features.copy_(torch.where(first, mean, new))
        self.feature_sum.zero_()
        self.feature_count.zero_()

    def fuse_with_meta_features(self, current, level: int):
        """(B, K, D) current keypoint features fused with the level's
        memory: gated attention over [current, memory] tokens, the current
        tokens' outputs through `proj`, plus the input."""
        mem = self.meta_features[level].to(current.dtype).expand_as(current)
        tokens = torch.cat([current, mem], dim=1)            # (B, 2K, D)
        fused = self.fusers[level](tokens)[:, :current.shape[1]]
        return self.proj(fused) + current

    def forward(self, feats: Sequence, kpts_per_level, vis,
                accumulate: bool = True):
        """Per level the fused (B, K, D) features; with `accumulate` the
        pooled features also go into the running sums."""
        outs = []
        for i, (f, kp) in enumerate(zip(feats, kpts_per_level)):
            pooled = gaussian_pool(f, kp, vis)
            outs.append(self.fuse_with_meta_features(pooled, i))
            if accumulate:
                with torch.no_grad():
                    self._accumulate(i, pooled.detach(), vis)
        return outs
