"""Batched heatmap inference for the heatmap family, SimpleBaseline,
HRNetPose and ViTPose (counterpart of tpupose/engine/predictor.py,
HeatmapPredictor only): uint8 crops -> heatmaps -> (flip-test) -> DARK
decode -> source-coordinate keypoints, all on the device; only the
(B, K, 2) coordinates and (B, K) scores return to the host.
"""

from __future__ import annotations

import numpy as np


class HeatmapPredictor:
    def __init__(self, model, heatmap_size, decode: str = "dark",
                 flip_test: bool = False, flip_pairs=None, udp: bool = False,
                 device="cuda", int8_engine=None, quant_scales=None):
        """model: a tpupose_torch heatmap model, SimpleBaseline, HRNetPose
        or ViTPose (see TopDownEvaluator); device defaults to "cuda" and
        raises where CUDA is absent. quant_scales: {module name: amax}
        from `calibrate_int8`, the forward with those layers in int8
        (ops/quant.py). int8_engine: an ops/int8_engine.Int8Engine built
        from this model (SimpleBaseline or HRNet: int8 products, BN and
        normalize folded into the convs), or an
        ops/cuda_engine.CudaServingEngine built from a SimpleBaseline-R50
        (the hand-written int8 kernels)."""
        from tpupose_torch.engine.evaluator import TopDownEvaluator

        self._ev = TopDownEvaluator(model, heatmap_size, decode=decode,
                                    flip_test=flip_test,
                                    flip_pairs=flip_pairs, udp=udp,
                                    device=device, int8_engine=int8_engine,
                                    quant_scales=quant_scales)

    @staticmethod
    def calibrate_int8(model, images):
        """int8 activation scales {module name: amax} from representative
        uint8 crop batches (a sequence of (B, H, W, 3) arrays or tensors,
        or one), normalized as the evaluator normalizes them, on the
        model's device."""
        import torch

        from tpupose_torch.ops.preprocess import normalize_images
        from tpupose_torch.ops.quant import calibrate

        if hasattr(images, "shape"):
            images = [images]
        p = next(model.parameters())
        return calibrate(model.eval(), images, preprocess=lambda b: (
            normalize_images(torch.as_tensor(b, device=p.device))
            .to(p.dtype)))

    @property
    def evaluator(self):
        return self._ev

    def __call__(self, images, centers=None, scales=None):
        """images: (B, H, W, 3) uint8 crops (numpy or tensor).
        centers/scales (B, 2) map results back to source coords; identity
        (crop coords) when omitted. Returns numpy (coords (B, K, 2),
        scores (B, K))."""
        B, H, W = images.shape[0], images.shape[1], images.shape[2]
        if centers is None:
            centers = np.tile([[W / 2, H / 2]], (B, 1)).astype(np.float32)
        if scales is None:
            scales = np.tile([[W, H]], (B, 1)).astype(np.float32)
        coords, scores = self._ev.step(images, centers, scales)
        return coords.cpu().numpy(), scores.cpu().numpy()
