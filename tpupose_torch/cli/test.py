"""Drawing for the inference CLIs (the port's copy of the renderer of
tpupose/cli/test.py: `draw_detections` and its two skeletons). The rest
of `cli.test` (folder inference with NMS and rescaling) waits for
DINOv3Pose training (ROADMAP Queue A); `cli.video` draws with this.
"""

from __future__ import annotations

import numpy as np

# skeleton for the reference's 4-kpt object poses: 0-1-2-3-0 + midline
# (HPE/test.py:189-277 draw_detections)
DEFAULT_SKELETON_4 = ((0, 1), (1, 2), (2, 3), (3, 0))

# COCO-17 person skeleton (limbs by keypoint index)
COCO_SKELETON_17 = ((15, 13), (13, 11), (16, 14), (14, 12), (11, 12),
                    (5, 11), (6, 12), (5, 6), (5, 7), (6, 8), (7, 9),
                    (8, 10), (1, 2), (0, 1), (0, 2), (1, 3), (2, 4),
                    (3, 5), (4, 6))


def draw_detections(image, keypoints, scores, valid, skeleton=None, radius=3):
    """Pure-NumPy renderer: dots + skeleton lines onto an RGB uint8 image."""
    img = image.copy()
    H, W = img.shape[:2]
    K = keypoints.shape[1]
    if skeleton is None:
        skeleton = (DEFAULT_SKELETON_4 if K == 4
                    else COCO_SKELETON_17 if K == 17 else ())

    def dot(x, y, color):
        x, y = int(round(x)), int(round(y))
        if 0 <= x < W and 0 <= y < H:
            y0, y1 = max(0, y - radius), min(H, y + radius + 1)
            x0, x1 = max(0, x - radius), min(W, x + radius + 1)
            img[y0:y1, x0:x1] = color

    def line(p, q, color):
        n = int(max(abs(q[0] - p[0]), abs(q[1] - p[1]), 1))
        for t in np.linspace(0, 1, n * 2):
            dot(p[0] + (q[0] - p[0]) * t, p[1] + (q[1] - p[1]) * t, color)

    for i in range(keypoints.shape[0]):
        if not valid[i]:
            continue
        kps = keypoints[i]
        for a, b in skeleton:
            if kps[a, 2] > 0.5 and kps[b, 2] > 0.5:
                line(kps[a, :2], kps[b, :2], (0, 255, 0))
        for k in range(K):
            if kps[k, 2] > 0.5:
                dot(kps[k, 0], kps[k, 1], (255, 0, 0))
    return img
