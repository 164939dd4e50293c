"""tpupose_torch.models.backbones."""
