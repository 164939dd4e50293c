"""Box format conversions (counterpart of tpupose/losses/bbox.py,
xywh2xyxy and xyxy2xywh; the keypoint box and CIoU come with DINOv3Pose
training, ROADMAP Queue A)."""

from __future__ import annotations

import torch


def xywh2xyxy(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
