"""ROI mean-pooling of a backbone feature map into per-detection
appearance embeddings, on the device (counterpart of tpupose/ops/roi.py).

A summed-area table over the map makes each box's mean four gathers:
static shapes, no loop over boxes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def integral_image(fmap: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) -> float32 summed-area table (B, h+1, w+1, C):
    S[b, y, x] = sum of fmap[b, :y, :x]."""
    s = fmap.float().cumsum(1).cumsum(2)
    return F.pad(s, (0, 0, 1, 0, 1, 0))


def roi_mean_pool(fmap: torch.Tensor, boxes: torch.Tensor, image_size,
                  l2_normalize: bool = True) -> torch.Tensor:
    """Mean of `fmap` (B, h, w, C) over each box of `boxes` (B, D, 4),
    xyxy in the pixels of the model input of size `image_size` (H, W);
    the map's stride is w / W, h / H. Returns (B, D, C) float32,
    L2-normalized by default. A degenerate or padded box covers at least
    one cell, so every result is finite (mask with the NMS `valid`)."""
    B, h, w, _ = fmap.shape
    H, W = image_size
    sx, sy = w / W, h / H
    x0 = torch.clamp(torch.floor(boxes[..., 0] * sx), 0, w - 1)
    y0 = torch.clamp(torch.floor(boxes[..., 1] * sy), 0, h - 1)
    x1 = torch.ceil(boxes[..., 2] * sx).maximum(x0 + 1).clamp_max(w).long()
    y1 = torch.ceil(boxes[..., 3] * sy).maximum(y0 + 1).clamp_max(h).long()
    x0, y0 = x0.long(), y0.long()
    S = integral_image(fmap)
    b = torch.arange(B, device=fmap.device)[:, None]
    total = S[b, y1, x1] - S[b, y0, x1] - S[b, y1, x0] + S[b, y0, x0]
    area = ((y1 - y0) * (x1 - x0)).float()[..., None]
    emb = total / area
    if l2_normalize:
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                     + 1e-9)
    return emb
