"""Appearance + IoU multi-person tracker (the port's copy of
tpupose/engine/tracker.py; host numpy, no torch): each frame's
detections are matched to the live tracks by a weighted sum of the
cosine similarity of their appearance embeddings (the detector
backbone's features pooled at each box, ops/roi.py) and box IoU,
greedily, best pair first; unmatched detections start tracks, tracks
unmatched for more than `max_age` frames end.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

# keypoint trajectory kept per track (for downstream consumers, e.g.
# temporal smoothing / action features); bounded so hour-long videos
# don't grow memory without limit
HISTORY_LEN = 64


@dataclass
class Track:
    track_id: int
    box: np.ndarray                 # (4,) xyxy
    feature: np.ndarray             # (D,) appearance embedding
    keypoints: np.ndarray           # (K, 3)
    age: int = 0                    # frames since last match
    hits: int = 1
    history: deque = field(
        default_factory=lambda: deque(maxlen=HISTORY_LEN))


def _iou(a, b):
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    ab = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


class PoseTracker:
    def __init__(self, appearance_weight: float = 0.7, iou_weight: float = 0.3,
                 match_threshold: float = 0.3, max_age: int = 30,
                 feature_momentum: float = 0.9):
        self.aw = appearance_weight
        self.iw = iou_weight
        self.thresh = match_threshold
        self.max_age = max_age
        self.momentum = feature_momentum
        self.tracks: list[Track] = []
        self._next_id = 0

    def update(self, boxes, features, keypoints):
        """One frame. boxes (N,4) xyxy, features (N,D), keypoints (N,K,3).
        Returns list of (track_id, box, keypoints) for matched/new tracks."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        features = np.asarray(features, np.float32)
        keypoints = np.asarray(keypoints, np.float32)
        N = boxes.shape[0]

        matched_t, matched_d = set(), set()
        if self.tracks and N:
            tf = np.stack([t.feature for t in self.tracks])
            tb = np.stack([t.box for t in self.tracks])
            fn = features / (np.linalg.norm(features, axis=1, keepdims=True) + 1e-9)
            tn = tf / (np.linalg.norm(tf, axis=1, keepdims=True) + 1e-9)
            sim = tn @ fn.T                                   # (T, N)
            iou = _iou(tb, boxes)
            cost = self.aw * sim + self.iw * iou

            # greedy best-first matching as iterative argmax over the
            # (T, N) matrix
            while True:
                t, d = np.unravel_index(int(np.argmax(cost)), cost.shape)
                if cost[t, d] < self.thresh:
                    break
                matched_t.add(int(t))
                matched_d.add(int(d))
                cost[t, :] = -np.inf
                cost[:, d] = -np.inf
                tr = self.tracks[t]
                tr.box = boxes[d]
                tr.keypoints = keypoints[d]
                tr.feature = (self.momentum * tr.feature
                              + (1 - self.momentum) * features[d])
                tr.age = 0
                tr.hits += 1
                tr.history.append(keypoints[d])

        for t, tr in enumerate(self.tracks):
            if t not in matched_t:
                tr.age += 1
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]

        for d in range(N):
            if d not in matched_d:
                self.tracks.append(Track(
                    self._next_id, boxes[d], features[d], keypoints[d],
                    history=deque([keypoints[d]], maxlen=HISTORY_LEN)))
                self._next_id += 1

        return [(t.track_id, t.box, t.keypoints)
                for t in self.tracks if t.age == 0]
