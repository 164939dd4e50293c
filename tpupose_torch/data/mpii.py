"""MPII single-person top-down dataset (the port's copy of
tpupose/data/mpii.py).

Parses the MPII annotation JSON of the MSRA / SimpleBaseline lineage
(`[{image, center, scale, joints, joints_vis}]`), applies MPII's
center/scale conventions and reuses the COCO top-down machinery of
data/coco.py (host decode + affine crop, scale / rotation / flip
augmentation, heatmap-coordinate labels):
  * MATLAB's 1-based center and joints -> 0-based (`- 1`);
  * `center_y += 15 * scale`, then `scale *= 1.25` (MSRA's loose crop
    around the head, and the only padding: `padding` defaults to 1.0, so
    the crop box is exactly `scale * 200` px);
  * the pixel box is aspect-corrected to the model input's ratio.

Evaluation: 16 joints, PCKh@0.5 on the head segment (9 = head top, 8 =
upper neck), the defaults of tpupose_torch.metrics.pckh; `flip_pairs`
(MPII_FLIP_PAIRS) reaches the Trainer's evaluator.
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpupose_torch.data.coco import CocoTopDownDataset, fit_aspect
from tpupose_torch.utils.logging import printT

MPII_NUM_KEYPOINTS = 16
# l-ankle/r-ankle, l-knee/r-knee, l-hip/r-hip, l-wrist/r-wrist,
# l-elbow/r-elbow, l-shoulder/r-shoulder
MPII_FLIP_PAIRS = np.array(
    [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]], np.int64)


class MpiiTopDownDataset(CocoTopDownDataset):
    def __init__(self, image_dir: str, ann_file: str, image_size=(256, 256),
                 heatmap_size=(64, 64), is_train: bool = True,
                 scale_factor: float = 0.25, rotation_factor: float = 30.0,
                 flip_prob: float = 0.5, padding: float = 1.0, seed: int = 0,
                 decode_threads: int = 4, augment_geometry: bool = True,
                 half_body_prob: float = 0.0,
                 half_body_min_joints: int = 8,
                 udp: bool = False):
        super().__init__(image_dir, None, image_size=image_size,
                         heatmap_size=heatmap_size, is_train=is_train,
                         scale_factor=scale_factor,
                         rotation_factor=rotation_factor,
                         flip_prob=flip_prob, padding=padding, seed=seed,
                         decode_threads=decode_threads,
                         flip_pairs=MPII_FLIP_PAIRS,
                         augment_geometry=augment_geometry,
                         half_body_prob=half_body_prob,
                         half_body_min_joints=half_body_min_joints, udp=udp)
        # MPII-16: thorax, neck, head and arms are the upper body; ankles,
        # knees, hips and pelvis (0-6) the lower
        self.upper_body_ids = (7, 8, 9, 10, 11, 12, 13, 14, 15)
        with open(ann_file) as f:
            anns = json.load(f)
        self._dims: dict[str, tuple[int, int]] = {}   # file -> (W, H), lazy
        for i, a in enumerate(anns):
            joints = np.asarray(a["joints"], np.float32).reshape(-1, 2) - 1.0
            vis = np.asarray(a["joints_vis"], np.float32).reshape(-1)
            center = np.asarray(a["center"], np.float32) - 1.0
            s = float(np.asarray(a["scale"]).reshape(-1)[0])
            if center[0] >= 0:                # MSRA loose-crop adjustment
                center = center.copy()
                center[1] = center[1] + 15.0 * s
                s = s * 1.25
            self.samples.append({
                "file_name": a["image"],
                "image_id": int(a.get("image_id", i)),
                "center0": center,
                "scale0": np.float32(s),
                "joints": joints,
                "visibility": vis,
                # OKS area proxy: the person's reference box
                "area": float((s * 200.0) ** 2 * 0.53),
            })
        printT(f"MPII top-down: {len(self.samples)} instances from {ann_file}")

    @classmethod
    def from_config(cls, cfg, split: str = "train"):
        d = cfg.data
        name = "train" if split == "train" else "valid"
        return cls(
            image_dir=os.path.join(d.root, "images"),
            ann_file=os.path.join(d.root, "annot", f"{name}.json"),
            image_size=tuple(d.image_size),
            heatmap_size=tuple(cfg.model.heatmap_size),
            is_train=(split == "train"),
            scale_factor=d.scale_factor, rotation_factor=d.rotation_factor,
            flip_prob=d.flip_prob, seed=cfg.train.seed,
            augment_geometry=not getattr(d, "device_affine", False),
            half_body_prob=getattr(d, "half_body_prob", 0.0),
            half_body_min_joints=getattr(d, "half_body_min_joints", 8),
            udp=getattr(d, "udp", False),
        )

    def _center_scale(self, s):
        """Stored MPII center / scale -> the pixel (w, h) box at the model
        input's aspect ratio; MSRA's 1.25 is already in scale0."""
        H, W = self.image_size
        side = float(s["scale0"]) * 200.0
        w, h = fit_aspect(side, side, W / H)
        return (s["center0"].astype(np.float32).copy(),
                np.array([w, h], np.float32) * self.padding)

    def _image_dims(self, file_name: str):
        """(W, H) of a source image from its header, cached (the MPII JSON
        stores no dimensions)."""
        d = self._dims.get(file_name)
        if d is None:
            from PIL import Image

            with Image.open(os.path.join(self.image_dir, file_name)) as im:
                d = im.size
            self._dims[file_name] = d
        return d

    def _sample_params(self, idx: int):
        # the flip and the native decode need the source's width / height
        s = self.samples[idx]
        if "width" not in s:
            w, h = self._image_dims(s["file_name"])
            s["width"], s["height"] = int(w), int(h)
        return super()._sample_params(idx)
