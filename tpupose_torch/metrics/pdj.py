"""PDJ, Percentage of Detected Joints (the port's copy of
tpupose/metrics/pdj.py): a joint is correct if its distance is at most
alpha x the torso diameter, the distance between two joints (by default
left shoulder and right hip). Float32 numpy, as pck.py.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.metrics.pck import PCK, _f32


class PDJ(PCK):
    def __init__(self, alpha: float = 0.2, torso_indices=(5, 12)):
        super().__init__(alpha=alpha)
        self.torso_indices = torso_indices

    def torso_size(self, gt, vis=None):
        i, j = self.torso_indices
        gt = _f32(gt)
        ts = np.linalg.norm(gt[:, i] - gt[:, j], axis=-1)
        if vis is not None:
            vis = _f32(vis)
            ok = (vis[:, i] > 0) & (vis[:, j] > 0)
            ts = np.where(ok, ts, np.float32(0.0))
        return ts

    def update(self, pred, gt, vis, normalizer=None):
        if normalizer is None:
            normalizer = self.torso_size(gt, vis)
        super().update(pred, gt, vis, normalizer=normalizer)

    def compute(self) -> dict:
        out = super().compute()
        out["pdj"] = out.pop("pck")
        return out
