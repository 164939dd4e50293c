"""tpupose_torch.losses."""
