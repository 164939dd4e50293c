"""MPJPE — Mean Per-Joint Position Error with visibility mask (the
port's copy of tpupose/metrics/mpjpe.py). Works for 2D or 3D joints;
float32 numpy, as pck.py."""

from __future__ import annotations

import numpy as np

from tpupose_torch.metrics.pck import _f32


class MPJPE:
    def __init__(self):
        self.reset()

    def reset(self):
        self.err_sum = 0.0
        self.count = 0

    def update(self, pred, gt, vis=None):
        d = np.linalg.norm(_f32(pred) - _f32(gt), axis=-1)  # (B, K)
        if vis is not None:
            m = _f32(vis) > 0
            self.err_sum += float(np.sum(d * m, dtype=np.float32))
            self.count += int(np.sum(m))
        else:
            self.err_sum += float(np.sum(d, dtype=np.float32))
            self.count += int(np.prod(d.shape))

    def compute(self) -> dict:
        return {"mpjpe": self.err_sum / max(self.count, 1)}
