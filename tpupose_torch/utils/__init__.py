"""tpupose_torch.utils."""
