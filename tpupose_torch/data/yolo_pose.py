"""YOLO-pose on-disk dataset: images/ + labels/ text pairs (the port's
copy of tpupose/data/yolo_pose.py).

Globs jpg/jpeg/png (sorted), parses every label file into RAM at
construction (a malformed one skips its image with a warning, a missing
one gives an image with no instances), pads 2-dim keypoints with v=1,
stretch-resizes each image to `image_size` and returns it as uint8 (the
normalization runs on the device in the train step). Every sample is
padded to `max_instances` rows with an `instance_mask`, so batches have
one static shape. JPEGs decode through the port's native runtime
(data/native_io.decode_jpeg_batch: DCT-prescaled decode + bilinear
resize) where it builds, else through PIL; PNGs always through PIL.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from tpupose_torch.utils.logging import printW

IMAGE_EXTS = ("*.jpg", "*.jpeg", "*.png")


class YoloPoseDataset:
    def __init__(self, image_dir: str, label_dir: str, image_size=(640, 640),
                 num_keypoints: int = 4, max_instances: int = 32):
        self.image_size = image_size
        self.num_keypoints = num_keypoints
        self.max_instances = max_instances
        paths = sorted(p for ext in IMAGE_EXTS
                       for p in glob.glob(os.path.join(image_dir, ext)))
        self.image_paths, self.labels = [], []
        for p in paths:
            stem = os.path.splitext(os.path.basename(p))[0]
            rows = self._parse_label(os.path.join(label_dir, stem + ".txt"))
            if rows is None:
                printW(f"skipping {p}: bad/missing label")
                continue
            self.image_paths.append(p)
            self.labels.append(rows)

    def _parse_label(self, path: str):
        """Rows `cls cx cy w h (x y [v])*K`, normalized; 2-dim keypoints
        get v = 1. None for a file of another column count."""
        from tpupose_torch.data.native_io import parse_yolo_label

        K = self.num_keypoints
        if not os.path.exists(path):
            return np.zeros((0, 5 + 3 * K), np.float32)
        rows = parse_yolo_label(path, 5 + 3 * K, max_rows=self.max_instances)
        if rows is not None:
            return rows
        rows = parse_yolo_label(path, 5 + 2 * K, max_rows=self.max_instances)
        if rows is None:
            return None
        out = np.ones((rows.shape[0], 5 + 3 * K), np.float32)
        out[:, :5] = rows[:, :5]
        out[:, 5::3] = rows[:, 5::2]
        out[:, 6::3] = rows[:, 6::2]
        return out

    def __len__(self):
        return len(self.image_paths)

    def _read_image(self, path: str):
        H, W = self.image_size
        if path.lower().endswith((".jpg", ".jpeg")):
            from tpupose_torch.data.native_io import decode_jpeg_batch

            return decode_jpeg_batch([path], H, W, num_threads=1)[0]
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB").resize((W, H)), np.uint8)

    def __getitem__(self, idx: int) -> dict:
        K, M = self.num_keypoints, self.max_instances
        rows = self.labels[idx][:M]
        n = rows.shape[0]
        boxes = np.zeros((M, 4), np.float32)
        cls = np.zeros((M,), np.int32)
        kpts = np.zeros((M, K, 3), np.float32)
        mask = np.zeros((M,), bool)
        if n:
            cls[:n] = rows[:, 0].astype(np.int32)
            boxes[:n] = rows[:, 1:5]
            kpts[:n] = rows[:, 5:].reshape(n, K, 3)
            mask[:n] = True
        return {
            "image": self._read_image(self.image_paths[idx]),
            "boxes": boxes, "classes": cls, "keypoints": kpts,
            "instance_mask": mask,
        }
