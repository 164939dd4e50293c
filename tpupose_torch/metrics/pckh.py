"""PCKh — PCK normalized by head size (the port's copy of
tpupose/metrics/pckh.py): the normalizer is the distance between two
head joints (e.g. MPII head-top and upper-neck) times 0.6, or an explicit
(N,) array. Float32 numpy, as pck.py.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.metrics.pck import PCK, _f32


class PCKh(PCK):
    def __init__(self, alpha: float = 0.5, head_indices=(9, 8), head_ratio: float = 0.6):
        super().__init__(alpha=alpha)
        self.head_indices = head_indices
        self.head_ratio = head_ratio  # MPII convention scales head segment by 0.6

    def head_size(self, gt, vis=None):
        gt = _f32(gt)
        i, j = self.head_indices
        hs = np.linalg.norm(gt[:, i] - gt[:, j], axis=-1) * np.float32(
            self.head_ratio)
        if vis is not None:
            vis = _f32(vis)
            ok = (vis[:, i] > 0) & (vis[:, j] > 0)
            hs = np.where(ok, hs, np.float32(0.0))
        return hs

    def update(self, pred, gt, vis, normalizer=None):
        if normalizer is None:
            normalizer = self.head_size(gt, vis)
        super().update(pred, gt, vis, normalizer=normalizer)

    def compute(self) -> dict:
        out = super().compute()
        out["pckh"] = out.pop("pck")
        return out
