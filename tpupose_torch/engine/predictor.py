"""Batched inference (counterpart of tpupose/engine/predictor.py):

- HeatmapPredictor, the heatmap family (SimpleBaseline, HRNetPose,
  ViTPose): uint8 crops -> heatmaps -> (flip-test) -> DARK decode ->
  source-coordinate keypoints, all on the device; only the (B, K, 2)
  coordinates and (B, K) scores return to the host.
- YoloPosePredictor, DINOv3Pose: uint8 frames -> decoded grid
  predictions -> NMS (ops/nms.py) -> fixed-size detections, and with
  `appearance` per-detection embeddings pooled from the backbone's
  deepest map (ops/roi.py), all on the device; `dispatch` queues the work
  without waiting for it, `fetch` brings a result home in one copy.
- BottomUpPredictor, BottomUpPose: uint8 frames -> heatmaps and tags
  (flip-averaged heatmaps with flip pairs) -> AE grouping
  (ops/ae_decode.py) -> fixed-size person arrays in input pixels, all on
  the device, fetched in one copy.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpupose_torch._device import resolve_device
from tpupose_torch.utils import trace


def to_host(tensors):
    """Device tensors -> numpy arrays through ONE device-to-host copy: the
    tensors' bytes are packed into one buffer on the device, copied, and
    cut apart on the host (each keeps its dtype; bf16 comes back as
    float32 holding the same values)."""
    tensors = [t.contiguous() for t in tensors]
    if tensors[0].device.type == "cpu":
        host = tensors
    else:
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
        flat = flat.cpu()
        host, pos = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            host.append(flat[pos:pos + n].clone().view(t.dtype)
                        .reshape(t.shape))
            pos += n
    return [h.float().numpy() if h.dtype == torch.bfloat16 else h.numpy()
            for h in host]


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
        with trace.root("serve.request"):
            B, H, W = images.shape[0], images.shape[1], images.shape[2]
            if centers is None:
                centers = np.tile([[W / 2, H / 2]], (B, 1)).astype(
                    np.float32)
            if scales is None:
                scales = np.tile([[W, H]], (B, 1)).astype(np.float32)
            coords, scores = self._ev.step(images, centers, scales)
            with trace.span("serve.d2h"):
                return coords.cpu().numpy(), scores.cpu().numpy()


class YoloPosePredictor:
    def __init__(self, model, num_classes: int, num_keypoints: int,
                 conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                 max_detections: int = 100, has_box_branch: bool = False,
                 quant_scales=None, appearance: bool = False,
                 device="cuda"):
        """model: a tpupose_torch DINOv3Pose, moved to `device` (default
        "cuda"; raises where CUDA is absent) and put in eval mode.
        has_box_branch: the head decodes boxes first (reg_max > 0, (B, A,
        4 + nc + 3K)); a box-free head's boxes are its keypoints' extent.
        quant_scales: {module name: amax} from `calibrate_int8`, the
        forward with those layers in int8 (ops/quant.py); NMS and decode
        stay float32. appearance: also return per-detection embeddings,
        the backbone's deepest map ROI-mean-pooled at the kept boxes
        (bf16, as JAX sends them), the tracker's appearance signal."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.nc = num_classes
        self.K = num_keypoints
        self.conf = conf_threshold
        self.iou = iou_threshold
        self.max_det = max_detections
        self.has_box = has_box_branch
        self.quant_scales = dict(quant_scales) if quant_scales else None
        self.appearance = appearance

    @staticmethod
    def calibrate_int8(model, images):
        """int8 activation scales {module name: amax} from representative
        uint8 frame batches (a sequence of (B, H, W, 3) arrays or tensors,
        or one), normalized as `dispatch` normalizes them."""
        from tpupose_torch.ops.preprocess import normalize_images
        from tpupose_torch.ops.quant import calibrate

        if hasattr(images, "shape"):
            images = [images]
        dev = next(model.parameters()).device
        return calibrate(model.eval(), images, preprocess=lambda b: (
            normalize_images(torch.as_tensor(b, device=dev),
                             scale_only=True)))

    @torch.no_grad()
    def _infer(self, images: torch.Tensor):
        from tpupose_torch.losses.bbox import xywh2xyxy
        from tpupose_torch.ops.nms import batched_pose_nms
        from tpupose_torch.ops.preprocess import normalize_images
        from tpupose_torch.ops.quant import quantized_apply
        from tpupose_torch.ops.roi import roi_mean_pool

        x = normalize_images(images, scale_only=True)
        kw = {"return_features": True} if self.appearance else {}
        if self.quant_scales is not None:
            out = quantized_apply(self.model, self.quant_scales, x, **kw)
        else:
            out = self.model(x, **kw)
        dec, fmap = out if self.appearance else (out, None)
        off = 4 if self.has_box else 0
        cls = dec[..., off:off + self.nc]
        scores = cls.amax(-1)
        classes = cls.argmax(-1).to(torch.int32)
        kpts = dec[..., off + self.nc:].reshape(dec.shape[0], -1, self.K, 3)
        if self.has_box:
            boxes = xywh2xyxy(dec[..., :4])
        else:
            xs, ys = kpts[..., 0], kpts[..., 1]
            boxes = torch.stack([xs.amin(2), ys.amin(2), xs.amax(2),
                                 ys.amax(2)], -1)
        out = batched_pose_nms(boxes, scores, classes, kpts, self.iou,
                               self.conf, self.max_det)
        if fmap is not None:
            emb = roi_mean_pool(fmap, out[0], tuple(images.shape[1:3]))
            out = out + (emb.to(torch.bfloat16),)
        return out

    def dispatch(self, images):
        """Queue the detection of one batch of uint8 (B, H, W, 3) frames
        on the device and return its device tensors (boxes, scores,
        classes, keypoints, valid[, features]) without waiting for them."""
        return self._infer(torch.as_tensor(images, device=self.device))

    @staticmethod
    def fetch(out):
        """Dispatched results -> dict of numpy arrays, one device-to-host
        copy for the whole tuple."""
        got = to_host(out)
        res = dict(zip(("boxes", "scores", "classes", "keypoints", "valid"),
                       got[:5]))
        if len(got) > 5:
            res["features"] = got[5]
        return res

    def __call__(self, images):
        """images: (B, H, W, 3) uint8. Returns dict of fixed-size arrays:
        boxes (B, D, 4), scores (B, D), classes (B, D), keypoints
        (B, D, K, 3), valid (B, D)[, features (B, D, C)]."""
        return self.fetch(self.dispatch(images))

    def pipeline(self, arrays, depth: int = 2, workers: int = 2):
        """Yield detection dicts for an iterable of frame batches, in
        order, with up to `depth` + 1 batches in flight: each batch's
        device work is queued before earlier results are fetched, on
        `workers` threads."""
        pool = ThreadPoolExecutor(max_workers=max(1, workers))
        q: deque = deque()
        try:
            for arr in arrays:
                q.append(pool.submit(self.fetch, self.dispatch(arr)))
                if len(q) > depth:
                    yield q.popleft().result()
            while q:
                yield q.popleft().result()
        finally:
            pool.shutdown(wait=False)


class BottomUpPredictor:
    def __init__(self, model, max_people: int = 30,
                 score_threshold: float = 0.1, tag_threshold: float = 1.0,
                 quant_scales=None, flip_test: bool = False,
                 flip_pairs=None, device="cuda"):
        """Detector-free multi-person inference. model: a tpupose_torch
        BottomUpPose, moved to `device` (default "cuda"; raises where
        CUDA is absent) and put in eval mode. flip_test mirror-averages
        the heatmaps (joints swapped by flip_pairs; without pairs it is
        off, as mirroring would average each joint with its
        contralateral location); the tags stay the direct pass's (a
        flipped forward embeds in another tag space). quant_scales:
        {module name: amax} from `calibrate_int8`, the forward with those
        layers in int8 (ops/quant.py)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_people = max_people
        self.score_threshold = score_threshold
        self.tag_threshold = tag_threshold
        self.quant_scales = dict(quant_scales) if quant_scales else None
        self.flip_pairs = np.asarray(flip_pairs if flip_pairs is not None
                                     else np.zeros((0, 2), np.int64))
        self.flip_test = flip_test and len(self.flip_pairs) > 0

    calibrate_int8 = staticmethod(HeatmapPredictor.calibrate_int8)

    def _forward(self, x):
        from tpupose_torch.ops.quant import quantized_apply

        if self.quant_scales is not None:
            return quantized_apply(self.model, self.quant_scales, x)
        return self.model(x)

    @torch.no_grad()
    def dispatch(self, images) -> dict:
        """Queue one batch of uint8 (B, H, W, 3) frames on the device:
        {coords (B, P, K, 2) input px, scores (B, P, K), person_scores
        (B, P), person_mask (B, P)} as device tensors, not waited for."""
        from tpupose_torch.models.bottom_up import BottomUpPose
        from tpupose_torch.ops.ae_decode import decode_ae
        from tpupose_torch.ops.decode import flip_back
        from tpupose_torch.ops.preprocess import normalize_images

        images = torch.as_tensor(images, device=self.device)
        H, W = images.shape[1:3]
        x = normalize_images(images)
        hm, tg = BottomUpPose.split(self._forward(x))
        if self.flip_test:
            hm_f, _ = BottomUpPose.split(self._forward(x.flip(2)))
            hm = 0.5 * (hm + flip_back(hm_f, self.flip_pairs))
        out = decode_ae(hm, tg, max_people=self.max_people,
                        score_threshold=self.score_threshold,
                        tag_threshold=self.tag_threshold)
        stride = torch.tensor([W / hm.shape[3], H / hm.shape[2]],
                              dtype=torch.float32, device=self.device)
        out["coords"] = out["coords"] * stride
        return out

    @staticmethod
    def fetch(out: dict) -> dict:
        """Dispatched results -> dict of numpy arrays, one device-to-host
        copy."""
        keys = ("coords", "scores", "person_scores", "person_mask")
        return dict(zip(keys, to_host([out[k] for k in keys])))

    def __call__(self, images):
        """images: (B, H, W, 3) uint8 frames. Returns numpy arrays: coords
        (B, P, K, 2) input px, scores (B, P, K), person_scores (B, P),
        person_mask (B, P)."""
        return self.fetch(self.dispatch(images))
