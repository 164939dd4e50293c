"""tpupose_torch: the PyTorch/CUDA port of tpupose for NVIDIA Hopper.

The package mirrors the layout of the JAX package `tpupose/` module for
module; each module's docstring names its JAX counterpart. It imports
`torch` only: nothing of JAX and nothing of `tpupose`.

Public layouts follow the JAX package: images are (B, H, W, 3) uint8
NHWC, models return heatmaps (B, Hh, Wh, K), decode takes (B, K, H, W).

Entry points (`SimpleBaseline`, `HeatmapPredictor`, `TopDownEvaluator`,
`PoseServer`) run on the card (`device="cuda"`) unless the caller asks
for the CPU with `device="cpu"`; asking for CUDA where there is none
raises. The hand-written Hopper kernels live in `tpupose_torch/csrc/`
and are built with nvcc at first use (`tpupose_torch/ops/_build.py`).
"""

from tpupose_torch._device import resolve_device

__all__ = ["resolve_device"]
