"""Symmetric int8 quantization helpers (counterpart of tpupose/ops/quant.py,
the part that the int8 engine's fold uses: `QMAX`, `quantize_weight`,
`quantize_activation`). The post-training-quantization intercept of the
JAX module (`calibrate`, `quantized_apply`) is not ported yet.
"""

from __future__ import annotations

import torch

QMAX = 127.0


def quantize_weight(kernel: torch.Tensor):
    """fp kernel (..., I, O) -> (int8 kernel, per-output-channel float32
    scale (O,)): symmetric max-abs per output channel, in float32, O last
    (the JAX layout, HWIO for a conv, (I, O) for a dense layer)."""
    k = kernel.to(torch.float32)
    dims = tuple(range(k.dim() - 1))
    ws = torch.clamp(k.abs().amax(dim=dims), min=1e-8)
    wq = torch.round(k / ws * QMAX).to(torch.int8)
    return wq, ws


def quantize_activation(x: torch.Tensor, scale: float) -> torch.Tensor:
    """fp activations -> int8 with the calibrated per-tensor scale."""
    q = torch.round(x.to(torch.float32) * (QMAX / scale))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)
