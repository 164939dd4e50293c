"""PCP / PCPm, Percentage of Correct Parts (the port's copy of
tpupose/metrics/pcp.py): a limb (joint pair) is correct when both its
endpoints are within alpha x the limb's length of their GT. PCPm takes
the dataset-mean limb length in place of each instance's. PCP's update
runs in float32 numpy (the JAX package's jnp default); PCPm keeps the
batches as given and computes in their dtype, as JAX's does.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.metrics.pck import _f32

# default limb set (COCO skeleton segments)
DEFAULT_LIMBS = (
    (5, 7), (7, 9),      # left arm
    (6, 8), (8, 10),     # right arm
    (11, 13), (13, 15),  # left leg
    (12, 14), (14, 16),  # right leg
)


class PCP:
    def __init__(self, alpha: float = 0.5, limbs=DEFAULT_LIMBS):
        self.alpha = alpha
        self.limbs = np.asarray(limbs)
        self.reset()

    def reset(self):
        self.correct = np.zeros(len(self.limbs), np.int64)
        self.total = np.zeros(len(self.limbs), np.int64)

    def _limb_lengths(self, gt):
        a = gt[:, self.limbs[:, 0]]
        b = gt[:, self.limbs[:, 1]]
        return np.linalg.norm(a - b, axis=-1)  # (B, L)

    def update(self, pred, gt, vis):
        pred, gt, vis = _f32(pred), _f32(gt), _f32(vis)
        i0, i1 = self.limbs[:, 0], self.limbs[:, 1]
        L = self._limb_lengths(gt)
        da = np.linalg.norm(pred[:, i0] - gt[:, i0], axis=-1)
        db = np.linalg.norm(pred[:, i1] - gt[:, i1], axis=-1)
        valid = (vis[:, i0] > 0) & (vis[:, i1] > 0) & (L > 0)
        thr = self._threshold(L)
        ok = (da <= thr) & (db <= thr) & valid
        self.correct += ok.sum(axis=0)
        self.total += valid.sum(axis=0)

    def _threshold(self, L):
        return np.float32(self.alpha) * L

    def compute(self) -> dict:
        per_limb = self.correct / np.maximum(self.total, 1)
        return {"pcp": float(per_limb.mean()), "per_limb": per_limb}


class PCPm(PCP):
    """PCP with the dataset-mean limb length as the threshold's base
    (the batches are kept until compute())."""

    def __init__(self, alpha: float = 0.5, limbs=DEFAULT_LIMBS):
        super().__init__(alpha=alpha, limbs=limbs)
        self._pending = []

    def reset(self):
        super().reset()
        self._pending = []

    def update(self, pred, gt, vis):
        self._pending.append((np.asarray(pred), np.asarray(gt),
                              np.asarray(vis)))

    def compute(self) -> dict:
        if not self._pending:
            return {"pcpm": 0.0, "per_limb": np.zeros(len(self.limbs))}
        i0, i1 = self.limbs[:, 0], self.limbs[:, 1]
        gts = np.concatenate([g for _, g, _ in self._pending])
        viss = np.concatenate([v for _, _, v in self._pending])
        lens = np.linalg.norm(gts[:, i0] - gts[:, i1], axis=-1)
        valid = (viss[:, i0] > 0) & (viss[:, i1] > 0)
        mean_len = (lens * valid).sum(0) / np.maximum(valid.sum(0), 1)
        correct = np.zeros(len(self.limbs), np.int64)
        total = np.zeros(len(self.limbs), np.int64)
        for pred, gt, vis in self._pending:
            da = np.linalg.norm(pred[:, i0] - gt[:, i0], axis=-1)
            db = np.linalg.norm(pred[:, i1] - gt[:, i1], axis=-1)
            v = (vis[:, i0] > 0) & (vis[:, i1] > 0)
            thr = self.alpha * mean_len[None, :]
            ok = (da <= thr) & (db <= thr) & v
            correct += ok.sum(0)
            total += v.sum(0)
        per_limb = correct / np.maximum(total, 1)
        return {"pcpm": float(per_limb.mean()), "per_limb": per_limb}
