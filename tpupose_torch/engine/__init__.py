"""tpupose_torch.engine."""
