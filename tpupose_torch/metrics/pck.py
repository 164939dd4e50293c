"""PCK — Percentage of Correct Keypoints (the port's copy of
tpupose/metrics/pck.py).

A keypoint is correct if ||pred - gt|| <= alpha * L where L is the GT
bbox max-side computed from visible joints (nan-safe masking), or a
user-supplied normalizer. Computed on the host in float32 numpy, the
precision of the JAX package's jnp default, so threshold decisions agree.
"""

from __future__ import annotations

import numpy as np


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _bbox_max_side(gt_kpts, vis):
    """L per instance from visible-joint extents (B,)"""
    gt_kpts, vis = _f32(gt_kpts), _f32(vis)
    big = np.float32(1e9)
    x = np.where(vis > 0, gt_kpts[..., 0], big)
    y = np.where(vis > 0, gt_kpts[..., 1], big)
    xmin = np.min(x, axis=-1)
    ymin = np.min(y, axis=-1)
    x = np.where(vis > 0, gt_kpts[..., 0], -big)
    y = np.where(vis > 0, gt_kpts[..., 1], -big)
    xmax = np.max(x, axis=-1)
    ymax = np.max(y, axis=-1)
    side = np.maximum(xmax - xmin, ymax - ymin)
    return np.where(np.sum(vis > 0, axis=-1) > 0, side, np.float32(0.0))


def _correct(pred, gt, vis, alpha, normalizer):
    """(ok, counted) masks (B, K) of one batch."""
    pred, gt, vis = _f32(pred), _f32(gt), _f32(vis)
    d = np.linalg.norm(pred - gt, axis=-1)                      # (B, K)
    L = _f32(normalizer) if normalizer is not None else _bbox_max_side(gt, vis)
    ok = (d <= alpha * L[..., None]) & (vis > 0) & (L[..., None] > 0)
    return ok, (vis > 0) & (L[..., None] > 0)


def pck_batch(pred, gt, vis, alpha: float = 0.2, normalizer=None):
    """(correct_count, visible_count) for a batch. pred/gt: (B,K,2), vis: (B,K)."""
    ok, cnt = _correct(pred, gt, vis, alpha, normalizer)
    return int(ok.sum()), int(cnt.sum())


class PCK:
    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.reset()

    def reset(self):
        self.correct = 0
        self.total = 0
        self.per_joint_correct = None
        self.per_joint_total = None

    def update(self, pred, gt, vis, normalizer=None):
        okn, cn = _correct(pred, gt, vis, self.alpha, normalizer)
        self.correct += int(okn.sum())
        self.total += int(cn.sum())
        pj_ok = okn.sum(axis=0)
        pj_cnt = cn.sum(axis=0)
        if self.per_joint_correct is None:
            self.per_joint_correct = pj_ok.astype(np.int64)
            self.per_joint_total = pj_cnt.astype(np.int64)
        else:
            self.per_joint_correct += pj_ok
            self.per_joint_total += pj_cnt

    def compute(self) -> dict:
        overall = self.correct / max(self.total, 1)
        pj = (self.per_joint_correct / np.maximum(self.per_joint_total, 1)
              if self.per_joint_correct is not None else None)
        return {"pck": float(overall), "per_joint": pj}
