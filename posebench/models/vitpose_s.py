"""The port's ViTPose on its DINOv3 ViT as its Builder makes it from the
yaml (float32 master weights, bf16 autocast where the yaml trains in
mixed precision), built on the device and given the benchmark's
weights."""

from __future__ import annotations

import torch


def build(cfg, weights: dict, device) -> torch.nn.Module:
    from tpupose_torch.models.vitpose import ViTPose

    m = cfg.model
    dtype = torch.bfloat16 if cfg.train.mixed_precision else torch.float32
    with torch.device(device):
        model = ViTPose(m.backbone, m.num_keypoints, m.decoder,
                        tuple(m.deconv_channels)[:2],
                        freeze_backbone=m.freeze_backbone, dtype=dtype,
                        device=device, param_dtype=torch.float32,
                        remat=cfg.train.remat)
    model.load_state_dict(weights, strict=True)
    return model
