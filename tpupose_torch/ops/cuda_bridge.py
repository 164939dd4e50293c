"""ResNet-50 block2_0, the "bridge" from layer1 to layer2 (counterpart of
tpupose/ops/pallas_bridge.py): 1x1 256->128, 3x3/2 128->128,
1x1 128->512, plus the 1x1/2 downsample 256->512, add, ReLU.

  - `fold_bridge_weights`: the block's conv + BN pairs folded (see
    cuda_layer1.fold_bottleneck);
  - `bridge_reference`: the plain PyTorch version;
  - `bridge`: the wrapper of csrc/bottleneck.cu (stride-2 variant), which
    replaces pallas_bridge.py `_bridge_kernel`. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    `bridge.launches` counts launches.
"""

from __future__ import annotations

import torch

from tpupose_torch.ops.cuda_layer1 import (bottleneck_reference,
                                           fold_bottleneck,
                                           launch_bottleneck)


def fold_bridge_weights(backbone, dtype=None) -> dict:
    """layer2 block 0 of a ResNet-50 -> folded weights."""
    return fold_bottleneck(backbone.layer2[0], dtype)


def bridge_reference(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """Plain version: (B, H, W, 256) -> (B, H/2, W/2, 512), x.dtype."""
    return bottleneck_reference(x, weights, 2)


def bridge(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """(B, H, W, 256) -> (B, H/2, W/2, 512). CPU: plain version; CUDA:
    one launch of the fused bottleneck kernel, stride 2."""
    if x.device.type == "cpu":
        return bridge_reference(x, weights)
    if x.device.type != "cuda":
        raise RuntimeError(f"bridge: unsupported device {x.device}")
    out = launch_bottleneck(x, weights, 2)
    bridge.launches += 1
    return out


bridge.launches = 0
