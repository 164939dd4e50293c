"""tpupose_torch.models."""
