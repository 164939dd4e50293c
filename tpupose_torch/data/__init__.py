"""tpupose_torch.data."""
