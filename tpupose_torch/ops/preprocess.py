"""Device-side image preprocessing (counterpart of tpupose/ops/preprocess.py).

uint8 crops go to the device as uint8 (4x fewer bytes than float32) and
are normalized there.
"""

from __future__ import annotations

import torch

# ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD, dtype=torch.bfloat16,
                     scale_only: bool = False) -> torch.Tensor:
    """uint8/float (B, H, W, C) -> normalized `dtype` NHWC.

    scale_only=True is the plain /255 path; otherwise ImageNet mean/std
    are applied. Arithmetic in float32, then one cast to `dtype`."""
    x = images.to(torch.float32) * (1.0 / 255.0)
    if not scale_only:
        m = torch.tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.tensor(std, dtype=torch.float32, device=x.device)
        x = (x - m) / s
    return x.to(dtype)
