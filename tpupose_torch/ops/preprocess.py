"""Device-side image preprocessing (counterpart of tpupose/ops/preprocess.py).

uint8 crops go to the device as uint8 (4x fewer bytes than float32) and
are normalized there. The train step's color jitter is split into a draw
(`draw_color_jitter`, from a torch.Generator) and an apply
(`color_jitter`), so a test can hand both frameworks the same draws.
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


def draw_color_jitter(generator: torch.Generator, batch: int,
                      strength: float = 0.2):
    """Per-image brightness, contrast and saturation factors, each
    1 + U(-strength, strength), shape (B,), on the generator's device.
    The JAX package draws the same distribution from jax.random
    (tpupose/ops/preprocess.py color_jitter); the bits differ."""
    dev = generator.device
    return tuple(1.0 + (torch.rand(batch, generator=generator, device=dev)
                        * 2.0 - 1.0) * strength for _ in range(3))


def color_jitter(images: torch.Tensor, factors) -> torch.Tensor:
    """float (B, H, W, C) in [0, 1], factors (brightness, contrast,
    saturation) each (B,) -> jittered images clipped to [0, 1]: scale by
    brightness, stretch about the per-image mean by contrast, then about
    the per-pixel gray by saturation (the JAX color_jitter with its
    draws given explicitly)."""
    bf, cf, sf = (f.reshape(-1, 1, 1, 1).to(images.dtype) for f in factors)
    x = images * bf
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * cf + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * sf + gray
    return torch.clamp(x, 0.0, 1.0)
