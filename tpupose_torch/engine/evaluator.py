"""Top-down evaluation step (counterpart of tpupose/engine/evaluator.py,
heatmap family): normalize -> forward (+ flipped forward, merge) -> DARK
decode -> back-projection to source coordinates.

For a SimpleBaseline-R50 at 256x192 (computing in bf16 on the card,
float32 master weights or not; any dtype on the CPU, where the kernels'
plain versions run) the forward is the composed kernel forward
`fast_r50_stem_apply` (fused stem+pool, layer1 and block2_0 kernels, the
input cast to the compute dtype, the model's tail under its autocast);
its folded weights are computed once, at construction, in the compute
dtype. It is the same function as the plain forward, which every
other model, dtype and size takes. A ViTPose takes its own forward, in
which each block's attention is the flash-attention kernel K8 on the
card (bf16 q/k/v).

With `int8_engine` (an ops/cuda_engine.CudaServingEngine built from the
model) the forward is the engine's uint8 -> heatmaps chain instead, the
normalize being folded into its stem; the flipped forward flips the raw
uint8 pixels. Merge, decode and back-projection are unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose_torch._device import resolve_device

# COCO-17 left/right keypoint pairs for flip-test
COCO_FLIP_PAIRS = np.array([
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16)
])

FAST_R50_INPUT_HW = (256, 192)


class TopDownEvaluator:
    def __init__(self, model, heatmap_size, decode: str = "dark",
                 flip_test: bool = True, flip_pairs=None,
                 blur_kernel: int = 11, sigma: float = 2.0,
                 udp: bool = False, device="cuda", int8_engine=None,
                 family: str = "heatmap"):
        """model: a tpupose_torch heatmap model, SimpleBaseline or
        ViTPose (or any module mapping normalized NHWC images to (B, Hh,
        Wh, K) heatmaps), moved to `device` and put in eval mode. udp:
        unit-length coordinate convention (back-projection on the
        (N-1)-interval grid, flip-test mirror without the 1-px shift).
        int8_engine: a CudaServingEngine built from this model, which
        replaces normalize + forward (SimpleBaseline-R50 only)."""
        from tpupose_torch.ops.cuda_stem import (compute_dtype, fold_fast_r50,
                                                 is_fast_r50)

        if family != "heatmap":
            raise ValueError(f"the port (and its int8_engine) serves the "
                             f"heatmap family only, got family={family!r}")
        if int8_engine is not None and \
                getattr(model, "backbone_name", None) != "resnet50":
            raise ValueError("int8_engine serves SimpleBaseline-R50 only, "
                             f"not {type(model).__name__} with backbone "
                             f"{getattr(model, 'backbone_name', None)!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.heatmap_size = tuple(heatmap_size)
        self.flip_pairs = (np.asarray(flip_pairs) if flip_pairs is not None
                           else COCO_FLIP_PAIRS)
        self.decode = decode
        self.flip_test = flip_test
        self.blur_kernel = blur_kernel
        self.sigma = sigma
        self.udp = udp
        self.int8_engine = int8_engine
        self.fast_weights = (fold_fast_r50(self.model)
                             if int8_engine is None and is_fast_r50(self.model)
                             else None)
        self.dtype = next(self.model.parameters()).dtype
        self.fast_dtype = compute_dtype(self.model)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> heatmaps (B, Hh, Wh, K)."""
        from tpupose_torch.ops.cuda_stem import fast_r50_stem_apply

        if (self.fast_weights is not None
                and tuple(x.shape[1:3]) == FAST_R50_INPUT_HW):
            return fast_r50_stem_apply(self.model, x.to(self.fast_dtype),
                                       self.fast_weights)
        return self.model(x.to(self.dtype))

    @torch.no_grad()
    def heatmaps(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the device -> float32 (B, K, Hh, Wh),
        flip-merged when flip_test is on."""
        from tpupose_torch.ops.decode import merge_flip
        from tpupose_torch.ops.preprocess import normalize_images

        if self.int8_engine is not None:
            # flipping raw uint8 pixels == flipping normalized pixels
            x, fwd = images, self.int8_engine.forward
        else:
            x, fwd = normalize_images(images), self.forward
        hm = fwd(x).permute(0, 3, 1, 2).float()
        if self.flip_test:
            hm_f = fwd(x.flip(2)).permute(0, 3, 1, 2).float()
            hm = merge_flip(hm, hm_f, self.flip_pairs, shift=not self.udp)
        return hm

    @torch.no_grad()
    def step(self, images, centers, scales):
        """One batch: uint8 crops (B, H, W, 3), centers/scales (B, 2) ->
        (source coords (B, K, 2), scores (B, K)) as device tensors."""
        from tpupose_torch.ops.affine import (affine_transform_points,
                                              get_affine_matrix)
        from tpupose_torch.ops.decode import decode_heatmaps

        images = torch.as_tensor(images, device=self.device)
        centers = torch.as_tensor(centers, dtype=torch.float32,
                                  device=self.device)
        scales = torch.as_tensor(scales, dtype=torch.float32,
                                 device=self.device)
        hm = self.heatmaps(images)
        coords, scores = decode_heatmaps(hm, self.decode, self.blur_kernel,
                                         self.sigma)
        m = get_affine_matrix(centers, scales, 0.0, self.heatmap_size,
                              udp=self.udp)
        return affine_transform_points(coords, m), scores
