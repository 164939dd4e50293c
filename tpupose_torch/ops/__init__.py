"""tpupose_torch.ops."""
