"""tpupose_torch.cli."""
