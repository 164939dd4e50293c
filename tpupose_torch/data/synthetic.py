"""Synthetic datasets for tests, smoke training, and benchmarking; the
port's copy of tpupose/data/synthetic.py (numpy only, same samples for
the same seed).

The reference has no test fixtures at all (SURVEY.md §4); these generators
are the fixture layer: deterministic, label-consistent fake data in both
the top-down (single person, heatmap) and YOLO-pose (multi-instance,
padded targets) formats.

The generated images contain bright blobs at the keypoint locations, so a
model *can* actually fit them — "loss decreases after 2 steps" integration
tests are meaningful, not vacuous.
"""

from __future__ import annotations

import numpy as np


class SyntheticTopDownDataset:
    """Single-person crops: uint8 NHWC images + joints in heatmap pixels."""

    def __init__(self, num_samples: int = 128, image_size=(256, 192),
                 heatmap_size=(64, 48), num_keypoints: int = 17, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = image_size
        self.heatmap_size = heatmap_size
        self.num_keypoints = num_keypoints
        rng = np.random.RandomState(seed)
        H, W = image_size
        Hh, Wh = heatmap_size
        K = num_keypoints
        # joints in heatmap coords, kept >= 2px inside the border so DARK
        # refinement is exercised
        self.joints = rng.uniform([2, 2], [Wh - 3, Hh - 3],
                                  size=(num_samples, K, 2)).astype(np.float32)
        self.vis = (rng.uniform(size=(num_samples, K)) > 0.1).astype(np.float32)
        self.centers = np.tile(np.array([W / 2, H / 2], np.float32), (num_samples, 1))
        self.scales = np.tile(np.array([W, H], np.float32), (num_samples, 1))

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        H, W = self.image_size
        Hh, Wh = self.heatmap_size
        sx, sy = W / Wh, H / Hh
        img = np.zeros((H, W, 3), np.float32)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        for k in range(self.num_keypoints):
            if self.vis[idx, k] <= 0:
                continue
            cx, cy = self.joints[idx, k, 0] * sx, self.joints[idx, k, 1] * sy
            d2 = (xs - cx) ** 2 + (ys - cy) ** 2
            img[..., k % 3] += 255.0 * np.exp(-d2 / (2 * 16.0))
        img = np.clip(img, 0, 255).astype(np.uint8)
        return {
            "image": img,
            "joints": self.joints[idx],
            "visibility": self.vis[idx],
            "center": self.centers[idx],
            "scale": self.scales[idx],
        }


class SyntheticYoloPoseDataset:
    """Multi-instance YOLO-pose format with static padding.

    Matches YoloPoseDataset's output contract: normalized
    [cls, cx, cy, w, h, (x, y, v) * K] rows padded to max_instances with a
    valid mask (a static-shape replacement for the reference's ragged
    concat collate, HPE/dataset.py:75-86). All samples are made at
    construction, a full-image Gaussian per keypoint each.
    """

    def __init__(self, num_samples: int = 64, image_size=(640, 640),
                 num_keypoints: int = 4, num_classes: int = 7,
                 max_instances: int = 8, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = image_size
        self.num_keypoints = num_keypoints
        self.num_classes = num_classes
        self.max_instances = max_instances
        self._rng = np.random.RandomState(seed)
        self._samples = [self._make() for _ in range(num_samples)]

    def _make(self):
        H, W = self.image_size
        K, M = self.num_keypoints, self.max_instances
        n = self._rng.randint(1, M + 1)
        boxes = np.zeros((M, 4), np.float32)       # cx cy w h, normalized
        cls = np.zeros((M,), np.int32)
        kpts = np.zeros((M, K, 3), np.float32)     # normalized x y + vis
        mask = np.zeros((M,), bool)
        img = np.zeros((H, W, 3), np.float32)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        for i in range(n):
            cx, cy = self._rng.uniform(0.2, 0.8, 2)
            w, h = self._rng.uniform(0.1, 0.3, 2)
            boxes[i] = (cx, cy, w, h)
            cls[i] = self._rng.randint(self.num_classes)
            for k in range(K):
                kx = np.clip(cx + self._rng.uniform(-w / 2, w / 2), 0.01, 0.99)
                ky = np.clip(cy + self._rng.uniform(-h / 2, h / 2), 0.01, 0.99)
                kpts[i, k] = (kx, ky, 2.0)
                d2 = (xs - kx * W) ** 2 + (ys - ky * H) ** 2
                img[..., k % 3] += 255.0 * np.exp(-d2 / (2 * 25.0))
            mask[i] = True
        return {
            "image": np.clip(img, 0, 255).astype(np.uint8),
            "boxes": boxes, "classes": cls, "keypoints": kpts,
            "instance_mask": mask,
        }

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> dict:
        return self._samples[idx]
