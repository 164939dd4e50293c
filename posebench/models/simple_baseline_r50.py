"""The port's SimpleBaseline-R50 as its Builder makes it from the yaml
(float32 master weights, bf16 autocast where the yaml trains in mixed
precision), built on the device and given the benchmark's weights."""

from __future__ import annotations

import torch


def build(cfg, weights: dict, device) -> torch.nn.Module:
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    m = cfg.model
    dtype = torch.bfloat16 if cfg.train.mixed_precision else torch.float32
    with torch.device(device):
        model = SimpleBaseline(m.backbone, m.num_keypoints,
                               tuple(m.deconv_channels), dtype=dtype,
                               device=device, param_dtype=torch.float32)
    model.load_state_dict(weights, strict=True)
    return model
