"""Top-down evaluation (counterpart of tpupose/engine/evaluator.py,
heatmap family): normalize -> forward (+ flipped forward, merge) -> DARK
decode -> back-projection to source coordinates, per batch on the device
(`step`), then metric accumulation on the host (`run`).

For a SimpleBaseline-R50 at 256x192 (computing in bf16 on the card,
float32 master weights or not; any dtype on the CPU, where the kernels'
plain versions run) the forward is the composed kernel forward
`fast_r50_stem_apply` (fused stem+pool, layer1 and block2_0 kernels, the
input cast to the compute dtype, the model's tail under its autocast);
its folded weights are computed at construction and again at every
`refresh(model)`, in the compute dtype. It is the same function as the
plain forward, which every other model, dtype and size takes (and the
R50 too with `fast_r50=False`). A ViTPose takes its own forward, in
which each block's attention is the flash-attention kernel K8 on the
card (bf16 q/k/v).

With `int8_engine` (an ops/cuda_engine.CudaServingEngine built from a
SimpleBaseline-R50, or an ops/int8_engine.Int8Engine built from any
SimpleBaseline or HRNetPose) the forward is the engine's uint8 ->
heatmaps chain instead, the normalize being folded into its stem; the
flipped forward flips the raw uint8 pixels. With `quant_scales` (from
ops/quant.calibrate) the model's own forward runs with its calibrated
layers in int8 (ops/quant.quantized_apply). Merge, decode and
back-projection are unchanged.

`run` drives the metric library (tpupose_torch/metrics) over a loader:
coordinate metrics get each batch, OKS-AP gets the crops regrouped by
source image id so multi-person images get proper greedy matching, each
instance scored by its mean keypoint confidence.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Sequence

import numpy as np
import torch

from tpupose_torch._device import resolve_device

# COCO-17 left/right keypoint pairs for flip-test
COCO_FLIP_PAIRS = np.array([
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16)
])

FAST_R50_INPUT_HW = (256, 192)


def visible_bbox_area(gt, vis):
    """Fallback OKS area when the dataset carries no annotation area:
    visible-joint bounding-box area. gt (B, K, 2), vis (B, K) -> (B,)."""
    v = vis > 0
    big = 1e9
    x = np.where(v, gt[..., 0], big)
    y = np.where(v, gt[..., 1], big)
    xmin, ymin = x.min(-1), y.min(-1)
    x = np.where(v, gt[..., 0], -big)
    y = np.where(v, gt[..., 1], -big)
    xmax, ymax = x.max(-1), y.max(-1)
    w = np.maximum(xmax - xmin, 1.0)
    h = np.maximum(ymax - ymin, 1.0)
    return np.where(v.any(-1), w * h, 1.0).astype(np.float32)


class TopDownEvaluator:
    def __init__(self, model, heatmap_size, decode: str = "dark",
                 flip_test: bool = True, flip_pairs=None,
                 blur_kernel: int = 11, sigma: float = 2.0,
                 udp: bool = False, device="cuda", int8_engine=None,
                 family: str = "heatmap", fast_r50: bool = True,
                 quant_scales=None):
        """model: a tpupose_torch heatmap model, SimpleBaseline, HRNetPose
        or ViTPose (or any module mapping normalized NHWC images to (B,
        Hh, Wh, K) heatmaps), moved to `device` and put in eval mode.
        udp: unit-length coordinate convention (back-projection on the
        (N-1)-interval grid, flip-test mirror without the 1-px shift).
        int8_engine: an engine built from this model, which replaces
        normalize + forward: an Int8Engine (SimpleBaseline or HRNet) or a
        CudaServingEngine (SimpleBaseline-R50 only). quant_scales:
        {module name: amax} from ops/quant.calibrate, the forward with
        those layers in int8. fast_r50=False: the model's own forward for
        the R50 too (the yardstick of the kernel route)."""
        from tpupose_torch.ops.int8_engine import Int8Engine

        if family != "heatmap":
            raise ValueError(f"the port (and its int8_engine) serves the "
                             f"heatmap family only, got family={family!r}")
        if int8_engine is not None and not isinstance(
                int8_engine, Int8Engine) and \
                getattr(model, "backbone_name", None) != "resnet50":
            raise ValueError("CudaServingEngine serves SimpleBaseline-R50 "
                             f"only, not {type(model).__name__} with "
                             f"backbone "
                             f"{getattr(model, 'backbone_name', None)!r}")
        self.device = resolve_device(device)
        self.heatmap_size = tuple(heatmap_size)
        self.flip_pairs = (np.asarray(flip_pairs) if flip_pairs is not None
                           else COCO_FLIP_PAIRS)
        self.decode = decode
        self.flip_test = flip_test
        self.blur_kernel = blur_kernel
        self.sigma = sigma
        self.udp = udp
        self.int8_engine = int8_engine
        self.quant_scales = dict(quant_scales) if quant_scales else None
        self.fast_r50 = fast_r50
        self.refresh(model)

    def refresh(self, model):
        """Evaluate `model` from now on: move it to the device, put it in
        eval mode and fold the kernel route's weights from its current
        parameters (a trainer calls this before every evaluation, so the
        kernels never run on the weights of an earlier one)."""
        from tpupose_torch.ops.cuda_stem import (compute_dtype, fold_fast_r50,
                                                 is_fast_r50)

        self.model = model.to(self.device).eval()
        self.fast_weights = (fold_fast_r50(self.model)
                             if self.fast_r50 and self.int8_engine is None
                             and self.quant_scales is None
                             and is_fast_r50(self.model) else None)
        self.dtype = next(self.model.parameters()).dtype
        self.fast_dtype = compute_dtype(self.model)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC images -> heatmaps (B, Hh, Wh, K)."""
        from tpupose_torch.ops.cuda_stem import fast_r50_stem_apply
        from tpupose_torch.ops.quant import quantized_apply

        if self.quant_scales is not None:
            return quantized_apply(self.model, self.quant_scales,
                                   x.to(self.dtype))
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

    def _fetch(self, coords, scores):
        """Start the copy of one batch's (B, K, 3) result to the host:
        pinned memory and a non_blocking copy on the card, with an event
        that marks its arrival. Returns (host tensor, event or None)."""
        out = torch.cat([coords, scores[..., None]], dim=-1).float()
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def run(self, loader, metrics: Sequence, gt_key: str = "joints_src",
            results_path: str | None = None):
        """Drive all metrics over a loader.

        loader yields dicts with images/center/scale, GT joints in source
        coords under `gt_key`, visibility, and optionally `area`,
        `image_id`, and a `pad_mask` marking padded tail rows (dropped
        here). Coordinate metrics (PCK/PCKh/MPJPE/AUC/EPE) get
        update(coords, gt, vis); OKSAP gets per-source-image groups of
        (pred, score, gt, vis, area). Returns the merged scalar results.

        results_path: also dump every prediction in the standard COCO
        keypoint-results JSON format ([{image_id, category_id, keypoints
        [x,y,s]*K, score}]), scoreable by pycocotools (COCOeval
        'keypoints'). The instance score is the mean keypoint confidence,
        matching the OKSAP scoring above.
        """
        from tpupose_torch.data.loader import to_device
        from tpupose_torch.metrics.oks_ap import OKSAP

        coord_metrics = [m for m in metrics if not isinstance(m, OKSAP)]
        ap_metrics = [m for m in metrics if isinstance(m, OKSAP)]
        groups: dict = {}
        results: list = []
        next_id = 0

        def accumulate(host, done, batch):
            nonlocal next_id
            if done is not None:
                done.synchronize()
            res = host.numpy()
            coords, scores = res[..., :2], res[..., 2]
            keep = np.asarray(batch["pad_mask"]).astype(bool) \
                if "pad_mask" in batch else np.ones(len(coords), bool)
            coords, scores = coords[keep], scores[keep]
            gt = np.asarray(batch[gt_key])[keep]
            vis = np.asarray(batch["visibility"])[keep]
            if results_path is not None:
                ids = (np.asarray(batch["image_id"]).reshape(-1)[keep]
                       if "image_id" in batch
                       else np.full(len(coords), -1))
                kps = np.concatenate([coords, scores[..., None]], axis=-1)
                for i in range(len(coords)):
                    results.append({
                        "image_id": int(ids[i]),
                        "category_id": 1,
                        "keypoints": [round(float(v), 3)
                                      for v in kps[i].reshape(-1)],
                        "score": round(float(scores[i].mean()), 5),
                    })
            for m in coord_metrics:
                m.update(coords, gt, vis)
            if ap_metrics:
                area = (np.asarray(batch["area"], np.float32)[keep]
                        if "area" in batch else visible_bbox_area(gt, vis))
                if "image_id" in batch:
                    ids = np.asarray(batch["image_id"]).reshape(-1)[keep]
                else:
                    ids = np.arange(next_id, next_id + len(coords))
                    next_id += len(coords)
                inst_score = scores.mean(axis=-1)  # mean kpt confidence
                for i, iid in enumerate(ids):
                    groups.setdefault(int(iid), []).append(
                        (coords[i], inst_score[i], gt[i], vis[i], area[i]))

        # Software-pipelined: each batch's step is queued on the device and
        # its small (B, K, 3) result's copy to pinned host memory started
        # before the previous batch's results are consumed, so device
        # compute, result copies and host metric accumulation overlap, two
        # batches in flight. Accumulation keeps the loader's order (FIFO):
        # OKSAP's greedy matching depends on it where scores tie.
        inflight: deque = deque()
        for batch in loader:
            dev = to_device({k: batch[k] for k in ("images", "center",
                                                   "scale")}, self.device)
            coords, scores = self.step(dev["images"], dev["center"],
                                       dev["scale"])
            inflight.append((*self._fetch(coords, scores), batch))
            while len(inflight) > 2:
                accumulate(*inflight.popleft())
        while inflight:
            accumulate(*inflight.popleft())
        for items in groups.values():
            pk = np.stack([it[0] for it in items])
            ps = np.asarray([it[1] for it in items], np.float32)
            gk = np.stack([it[2] for it in items])
            gv = np.stack([it[3] for it in items])
            ga = np.asarray([it[4] for it in items], np.float32)
            for m in ap_metrics:
                # top-down preds come from known person crops: the
                # detection's own area IS the crop area (drives AP_M/AP_L)
                m.update(pk, ps, gk, gv, ga, pred_area=ga)
        if results_path is not None:
            d = os.path.dirname(results_path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(results_path, "w") as f:
                json.dump(results, f)
        out = {}
        for m in metrics:
            out.update({k: float(v) for k, v in m.compute().items()
                        if np.isscalar(v) or isinstance(v, float)})
        return out
