"""Two-stage pose: detector boxes -> crops on the device -> batched
top-down pose -> frame coordinates (counterpart of
tpupose/engine/two_stage.py).

Boxes become centre/scale (the MSRA aspect and 1.25 padding, as
data/coco.py), then dst->src matrices; the warp kernel K7
(ops/cuda_warp.crops_from_frames: D crops per frame, read from the frame
in place) cuts the (B*D) crops; the heatmap model runs on them through
TopDownEvaluator.forward, so a SimpleBaseline-R50 at 256x192 takes the
kernel route (K1 stem, K2 layer1, K3 block2_0); DARK decode (K4 on the
card) and back-projection give frame pixels. No flip, as in JAX. Static
shapes: D = max_persons crops a frame, an invalid slot's box replaced by
a safe [0, 0, 2, 2] and masked by `valid`.
"""

from __future__ import annotations

import numpy as np
import torch

SAFE_BOX = (0.0, 0.0, 2.0, 2.0)


def boxes_to_center_scale(boxes_xyxy: torch.Tensor, aspect: float,
                          padding: float = 1.25):
    """(..., 4) xyxy -> centre (..., 2), scale (..., 2) at the target
    aspect ratio (w / h) with padding."""
    x0, y0, x1, y1 = boxes_xyxy.unbind(-1)
    w = (x1 - x0).clamp_min(1.0)
    h = (y1 - y0).clamp_min(1.0)
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    wide = w > aspect * h
    w2 = torch.where(wide, w, h * aspect)
    h2 = torch.where(wide, w / aspect, h)
    return (torch.stack([cx, cy], -1),
            torch.stack([w2, h2], -1) * padding)


def person_crops(frames: torch.Tensor, boxes: torch.Tensor,
                 valid: torch.Tensor, crop_size, padding: float = 1.25,
                 udp: bool = False):
    """frames (B, Hf, Wf, 3); boxes (B, D, 4) xyxy frame px; valid (B, D)
    -> (crops (B*D, H, W, 3) float32, centre (B*D, 2), scale (B*D, 2)).
    The crops come from the warp kernel on a CUDA tensor, from its plain
    version on a CPU one."""
    from tpupose_torch.ops.affine import get_affine_matrix
    from tpupose_torch.ops.cuda_warp import crops_from_frames

    B, D = boxes.shape[0], boxes.shape[1]
    H, W = crop_size
    safe = torch.tensor(SAFE_BOX, dtype=boxes.dtype, device=boxes.device)
    bx = torch.where(valid[..., None] > 0, boxes, safe)
    center, scale = boxes_to_center_scale(bx, W / H, padding)
    center, scale = center.reshape(B * D, 2), scale.reshape(B * D, 2)
    mats = get_affine_matrix(center, scale, 0.0, (H, W), udp=udp)
    return crops_from_frames(frames, mats, (H, W)), center, scale


class TwoStagePosePredictor:
    """An optional detector + a top-down heatmap model over crops cut on
    the device.

    pose_model: a tpupose_torch heatmap model (SimpleBaseline, HRNetPose,
      ViTPose); crop_size its input (H, W), heatmap_size its output grid.
    detector: optional; a YoloPosePredictor (whose `dispatch` lets the
      two stages chain on the device) or any callable returning
      {"boxes", "scores", "valid"} for a frame batch. `pose_from_boxes`
      takes boxes from any source.
    quant_scales: {module name: amax} for the pose model (ops/quant.py,
      HeatmapPredictor.calibrate_int8 on person crops).
    device defaults to "cuda" and raises where CUDA is absent.
    """

    def __init__(self, pose_model, crop_size, heatmap_size,
                 max_persons: int = 16, decode: str = "dark",
                 padding: float = 1.25, detector=None, quant_scales=None,
                 udp: bool = False, device="cuda"):
        from tpupose_torch.engine.evaluator import TopDownEvaluator

        self.crop_size = tuple(crop_size)
        self.heatmap_size = tuple(heatmap_size)
        self.max_persons = max_persons
        self.padding = padding
        self.detector = detector
        self.udp = udp
        self._ev = TopDownEvaluator(pose_model, heatmap_size, decode=decode,
                                    flip_test=False, udp=udp, device=device,
                                    quant_scales=quant_scales)
        self.device = self._ev.device

    @torch.no_grad()
    def _pose_step(self, frames, boxes, valid):
        """frames (B, Hf, Wf, 3) uint8/float; boxes (B, D, 4) xyxy frame
        px; valid (B, D) -> coords (B, D, K, 2) frame px, scores
        (B, D, K), device tensors."""
        from tpupose_torch.ops.affine import transform_preds
        from tpupose_torch.ops.decode import decode_heatmaps
        from tpupose_torch.ops.preprocess import normalize_images

        B, D = boxes.shape[0], boxes.shape[1]
        crops, center, scale = person_crops(frames, boxes, valid,
                                            self.crop_size, self.padding,
                                            self.udp)
        hm = self._ev.forward(normalize_images(crops))
        hm = hm.permute(0, 3, 1, 2).float()
        coords, scores = decode_heatmaps(hm, self._ev.decode)
        src = transform_preds(coords, center, scale, self.heatmap_size,
                              udp=self.udp)
        K = src.shape[-2]
        return src.reshape(B, D, K, 2), scores.reshape(B, D, K)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def pose_from_boxes(self, frames, boxes, valid):
        """numpy (or tensors) in, numpy (coords, scores) out; one copy
        back."""
        from tpupose_torch.engine.predictor import to_host

        coords, scores = to_host(self._pose_step(
            self._tensor(frames), self._tensor(boxes, torch.float32),
            self._tensor(valid)))
        return coords, scores

    def dispatch_from_det(self, frames, det_out):
        """Chain stage 2 onto a YoloPosePredictor.dispatch result on the
        device: det_out is its (boxes, scores, classes, keypoints,
        valid[, features]) tuple. Returns device tensors for `fetch`,
        without waiting for them."""
        D = self.max_persons
        boxes, scores, valid = (det_out[0][:, :D], det_out[1][:, :D],
                                det_out[4][:, :D])
        coords, pscores = self._pose_step(self._tensor(frames), boxes, valid)
        out = (boxes, scores, valid, coords, pscores)
        if len(det_out) > 5:             # the detector's embeddings
            out = out + (det_out[5][:, :D],)
        return out

    @staticmethod
    def fetch(out):
        """One device-to-host copy for a two-stage chunk's results."""
        from tpupose_torch.engine.predictor import to_host

        got = to_host(out)
        boxes, scores, valid, coords, pscores = got[:5]
        res = {"boxes": boxes, "det_scores": scores, "valid": valid,
               "keypoints": np.concatenate([coords, pscores[..., None]],
                                           -1)}
        if len(got) > 5:
            res["features"] = got[5]
        return res

    def __call__(self, frames):
        """frames (B, Hf, Wf, 3) uint8 -> dict with the detector's boxes
        and the refined keypoints (B, D, K, 3) [x, y, score] in frame
        pixels. A detector with `dispatch` chains on the device (one
        upload, one copy back); any other callable costs a round trip
        between the stages."""
        if self.detector is None:
            raise ValueError("no detector attached; use pose_from_boxes")
        if hasattr(self.detector, "dispatch"):
            arr = self._tensor(frames)
            return self.fetch(self.dispatch_from_det(
                arr, self.detector.dispatch(arr)))
        det = self.detector(frames)
        D = self.max_persons
        boxes, valid = det["boxes"][:, :D], det["valid"][:, :D]
        coords, scores = self.pose_from_boxes(frames, boxes, valid)
        return {"boxes": boxes, "det_scores": det["scores"][:, :D],
                "valid": valid,
                "keypoints": np.concatenate([coords, scores[..., None]],
                                            -1)}
