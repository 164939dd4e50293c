"""AUC — area under the PCK curve, and EPE, the mean end-point error
(the port's copy of tpupose/metrics/auc.py).

AUC integrates PCK over a threshold sweep (the MPII/FreiHAND summary),
EPE is the raw mean pixel error of visible joints. Normalization matches
PCK: GT bbox max-side from visible joints, or a user-supplied
per-instance normalizer.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.metrics.pck import _bbox_max_side

# numpy >= 2 names it trapezoid; 1.x only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class AUC:
    """Area under the normalized-PCK curve for thresholds in
    [0, max_threshold], trapezoid-integrated and divided by the range so a
    perfect predictor scores 1.0."""

    def __init__(self, max_threshold: float = 0.5, num_steps: int = 20):
        self.thresholds = np.linspace(0.0, max_threshold, num_steps + 1)
        self.max_threshold = max_threshold
        self.reset()

    def reset(self):
        self._nd = []          # normalized distances of counted joints

    def update(self, pred, gt, vis, normalizer=None):
        """pred/gt (B, K, 2), vis (B, K); normalizer optional (B,)."""
        pred = np.asarray(pred, np.float32)
        gt = np.asarray(gt, np.float32)
        vis = np.asarray(vis)
        d = np.linalg.norm(pred - gt, axis=-1)                    # (B, K)
        L = (np.asarray(normalizer, np.float32) if normalizer is not None
             else _bbox_max_side(gt, vis))
        ok = (vis > 0) & (L[..., None] > 0)
        nd = d / np.maximum(L[..., None], 1e-9)
        self._nd.append(nd[ok])

    def compute(self) -> dict:
        if not self._nd:
            return {"auc": 0.0, "epe_norm": 0.0}
        nd = np.concatenate(self._nd)
        pck = np.stack([(nd <= t).mean() for t in self.thresholds])
        auc = float(_trapezoid(pck, self.thresholds) / self.max_threshold)
        return {"auc": auc, "epe_norm": float(nd.mean())}


class EPE:
    """Mean end-point error of visible joints, in source-image pixels."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._n = 0

    def update(self, pred, gt, vis, normalizer=None):
        pred = np.asarray(pred, np.float32)
        gt = np.asarray(gt, np.float32)
        vis = np.asarray(vis)
        d = np.linalg.norm(pred - gt, axis=-1)
        m = vis > 0
        self._sum += float(d[m].sum())
        self._n += int(m.sum())

    def compute(self) -> dict:
        return {"epe": self._sum / max(self._n, 1)}
