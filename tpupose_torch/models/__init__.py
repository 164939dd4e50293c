"""tpupose_torch.models: the model registry (counterpart of
tpupose/models/__init__.py, for the families the port has). Classes are
imported on lookup, so importing a submodule does not import every
model."""

from __future__ import annotations

import importlib

MODELS = {
    "simple_baseline": "tpupose_torch.models.simple_baseline:SimpleBaseline",
    "hrnet": "tpupose_torch.models.backbones.hrnet:HRNetPose",
    "vitpose": "tpupose_torch.models.vitpose:ViTPose",
    "dinov3_pose": "tpupose_torch.models.dinov3_pose:DINOv3Pose",
    "deeppose": "tpupose_torch.models.deeppose:DeepPose",
    "simcc": "tpupose_torch.models.simcc:SimCCPose",
    "bottom_up": "tpupose_torch.models.bottom_up:BottomUpPose",
}


def get_model(name: str):
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
    module, cls = MODELS[name].split(":")
    return getattr(importlib.import_module(module), cls)
