"""Box geometry (counterpart of tpupose/losses/bbox.py): the xywh/xyxy
converters, the visibility-aware keypoint box with a 10% percentile
outlier trim, CIoU and plain pairwise IoU (for the assigner)."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def kpts_to_box(kpts, vis_mask, trim: float = 0.1, pad: float = 1.0):
    """Visibility-aware keypoints -> xywh box with percentile trimming:
    fewer than 2 visible joints fall back to all joints; more than 4
    usable joints trim max(1, floor(trim * n)) extremes a side; w and h
    are at least 1. kpts (..., K, 2), vis_mask (..., K) -> (..., 4)."""
    K = kpts.shape[-2]
    m = (vis_mask > 0).to(torch.float32)
    big = 1e9
    n_vis = m.sum(-1, keepdim=True)
    m_eff = torch.where(n_vis < 2, torch.ones_like(m), m)
    n_eff = m_eff.sum(-1, keepdim=True)
    k = torch.where(n_eff > 4,
                    torch.clamp_min(torch.floor(trim * n_eff), 1.0),
                    torch.zeros_like(n_eff))
    k = k.clamp(0, K - 1).to(torch.int64)

    def trimmed_minmax(coord):
        lo_sorted = torch.where(m_eff > 0, coord,
                                torch.full_like(coord, big)).sort(-1).values
        hi_sorted = torch.where(m_eff > 0, coord,
                                torch.full_like(coord, -big)).sort(-1).values
        lo = lo_sorted.gather(-1, k)[..., 0]
        hi = hi_sorted.gather(-1, (K - 1 - k).clamp(0, K - 1))[..., 0]
        return lo, hi

    xlo, xhi = trimmed_minmax(kpts[..., 0])
    ylo, yhi = trimmed_minmax(kpts[..., 1])
    w = torch.clamp_min(xhi - xlo, 1.0) * pad
    h = torch.clamp_min(yhi - ylo, 1.0) * pad
    return torch.stack([(xlo + xhi) / 2, (ylo + yhi) / 2, w, h], -1)


def ciou(box1, box2, eps: float = 1e-7):
    """Complete IoU between xywh boxes, elementwise on broadcastable
    shapes; the aspect term's alpha carries no gradient. Returns (...,)."""
    b1 = xywh2xyxy(box1)
    b2 = xywh2xyxy(box2)
    ix1 = torch.maximum(b1[..., 0], b2[..., 0])
    iy1 = torch.maximum(b1[..., 1], b2[..., 1])
    ix2 = torch.minimum(b1[..., 2], b2[..., 2])
    iy2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    w1, h1 = box1[..., 2], box1[..., 3]
    w2, h2 = box2[..., 2], box2[..., 3]
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    ex1 = torch.minimum(b1[..., 0], b2[..., 0])
    ey1 = torch.minimum(b1[..., 1], b2[..., 1])
    ex2 = torch.maximum(b1[..., 2], b2[..., 2])
    ey2 = torch.maximum(b1[..., 3], b2[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2 + eps
    rho2 = (box1[..., 0] - box2[..., 0]) ** 2 \
        + (box1[..., 1] - box2[..., 1]) ** 2
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                                - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1.0 + eps))).detach()
    return iou - rho2 / c2 - alpha * v


def pairwise_iou_xyxy(a, b, eps: float = 1e-9):
    """(..., N, 4) x (..., M, 4) -> (..., N, M) plain IoU."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    aa = (a[..., 2] - a[..., 0]).clamp_min(0) \
        * (a[..., 3] - a[..., 1]).clamp_min(0)
    ab = (b[..., 2] - b[..., 0]).clamp_min(0) \
        * (b[..., 3] - b[..., 1]).clamp_min(0)
    return inter / (aa[..., :, None] + ab[..., None, :] - inter + eps)
