"""Gaussian heatmap targets on the device (counterpart of
tpupose/ops/heatmap.py).

For each (batch, keypoint) the target is the dense surface
exp(-d^2 / 2 sigma^2) over the heatmap grid, one broadcasted expression:

  - `unbiased=True` (default): float-centre Gaussian (the DARK/UDP
    encoding), the pairing for the DARK decoder;
  - `unbiased=False`: centre rounded to the nearest pixel, the classic
    MSRA paste.
"""

from __future__ import annotations

import torch


def heatmap_target_weights(joints, visibility, heatmap_size,
                           sigma: float = 2.0) -> torch.Tensor:
    """Per-joint loss weights (bool): labeled (visibility > 0) AND the
    3-sigma box overlaps the heatmap (the MSRA rule).

    joints: (..., K, 2) in heatmap pixels (x, y); visibility: (..., K)."""
    H, W = heatmap_size
    x, y = joints[..., 0], joints[..., 1]
    r = 3.0 * sigma + 1.0
    inside = (x - r < W) & (x + r >= 0) & (y - r < H) & (y + r >= 0)
    return (visibility > 0) & inside


def gaussian_heatmaps(joints, visibility, heatmap_size, sigma: float = 2.0,
                      unbiased: bool = True, dtype=torch.float32):
    """joints (B, K, 2) in heatmap pixels, visibility (B, K) ->
    (targets (B, K, H, W), weights (B, K)), both `dtype`."""
    H, W = heatmap_size
    joints = joints.float()
    mu = joints if unbiased else torch.floor(joints + 0.5)
    mx = mu[..., 0, None, None]                       # (B, K, 1, 1)
    my = mu[..., 1, None, None]
    ys = torch.arange(H, dtype=torch.float32, device=joints.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=joints.device)[None, :]
    d2 = (xs - mx) ** 2 + (ys - my) ** 2
    g = torch.exp(-d2 / (2.0 * sigma * sigma)).to(dtype)
    w = heatmap_target_weights(joints, visibility, heatmap_size, sigma)
    g = g * w[..., None, None].to(dtype)
    return g, w.to(dtype)
