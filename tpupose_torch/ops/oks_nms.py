"""OKS-based non-maximum suppression over pose instances (the port's copy
of tpupose/ops/oks_nms.py, host numpy).

The COCO top-down protocol deduplicates overlapping person predictions
with OKS-NMS before AP scoring: two near-identical poses of one person
would otherwise count one as a false positive. It runs per image over
N <= max_detections instances after the results are on the host.

  oks_nms      hard suppression at `threshold` (protocol default 0.9)
  soft_oks_nms Gaussian rescoring score *= exp(-oks^2 / sigma_ns), the
               top max_dets kept after rescoring
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.metrics.oks_ap import default_sigmas


def oks_iou(pose, others, area, other_areas, sigmas=None, kscores=None,
            other_kscores=None, vis_threshold: float = 0.0):
    """OKS between one pose (K, 2) and N others (N, K, 2); area scalar,
    other_areas (N,). With vis_threshold > 0 and per-keypoint scores
    (K,) / (N, K), only joints both instances are confident about count."""
    if sigmas is None:
        sigmas = default_sigmas(pose.shape[0])
    sigmas = np.asarray(sigmas, np.float32)
    var = (2.0 * sigmas) ** 2
    d2 = np.sum((others - pose[None]) ** 2, axis=-1)  # (N, K)
    s = (area + other_areas)[:, None] / 2.0 + np.spacing(1)
    e = d2 / (2.0 * s * var[None])
    w = np.ones_like(e)
    if vis_threshold > 0 and kscores is not None and other_kscores is not None:
        w = ((kscores[None] > vis_threshold)
             & (other_kscores > vis_threshold)).astype(np.float32)
    num = np.sum(np.exp(-e) * w, axis=-1)
    den = np.maximum(np.sum(w, axis=-1), np.spacing(1))
    return num / den


def _pair_iou(kpts, areas, kscores, vis_threshold, sigmas, i, rest):
    return oks_iou(kpts[i], kpts[rest], areas[i], areas[rest], sigmas,
                   None if kscores is None else kscores[i],
                   None if kscores is None else kscores[rest],
                   vis_threshold)


def oks_nms(kpts, scores, areas, threshold: float = 0.9, sigmas=None,
            kscores=None, vis_threshold: float = 0.0) -> np.ndarray:
    """Greedy hard OKS-NMS. kpts (N, K, 2); scores, areas (N,). Returns
    the kept indices in descending-score order."""
    kpts = np.asarray(kpts, np.float32)
    scores = np.asarray(scores, np.float32)
    areas = np.asarray(areas, np.float32)
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        ious = _pair_iou(kpts, areas, kscores, vis_threshold, sigmas, i, rest)
        order = rest[ious <= threshold]
    return np.asarray(keep, np.int64)


def soft_oks_nms(kpts, scores, areas, sigma_ns: float = 0.1,
                 score_threshold: float = 1e-3, max_dets: int = 20,
                 sigmas=None, kscores=None, vis_threshold: float = 0.0):
    """Soft OKS-NMS with Gaussian rescoring. Returns (keep indices,
    rescored scores of the kept), ordered by the decayed score, at most
    max_dets; instances decayed below score_threshold are dropped."""
    kpts = np.asarray(kpts, np.float32)
    scores = np.asarray(scores, np.float32).copy()
    areas = np.asarray(areas, np.float32)
    order = np.argsort(-scores)
    keep, kept_scores = [], []
    while order.size and len(keep) < max_dets:
        i = order[0]
        keep.append(int(i))
        kept_scores.append(float(scores[i]))
        rest = order[1:]
        if not rest.size:
            break
        ious = _pair_iou(kpts, areas, kscores, vis_threshold, sigmas, i, rest)
        scores[rest] = scores[rest] * np.exp(-(ious ** 2) / sigma_ns)
        rest = rest[scores[rest] > score_threshold]
        order = rest[np.argsort(-scores[rest])]
    return np.asarray(keep, np.int64), np.asarray(kept_scores, np.float32)
