"""Greedy NMS with static shapes, batched over images (counterpart of
tpupose/ops/nms.py: box_iou, nms, batched_pose_nms).

The keep mask equals JAX's: the score order is a stable sort (as
jnp.argsort is; lower index first among equal scores), and JAX's
`lax.top_k` preselect, which also puts the lower index first among ties,
is a stable descending sort cut to k (torch.topk promises no order among
ties on the card). The greedy scan is sequential in the sorted order, as
JAX's fori_loop is, but one scan serves the whole batch: `cnt[b, i]`
counts the kept boxes ranked above i that overlap it beyond the
threshold, a box is kept when its count is 0 at its turn, and keeping it
adds its row of the overlap matrix to the counts (2 launches a step on
the card). Padded or invalid slots start at count 1 and are never kept.
Nothing waits for the device.
"""

from __future__ import annotations

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes a (..., N, 4) and b (..., M, 4) ->
    (..., N, M), in JAX's order of operations."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows `idx` (B, M) -> (B, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.45, valid=None) -> torch.Tensor:
    """Greedy NMS over (B, N, 4) xyxy boxes and (B, N) scores (or one
    image's (N, 4), (N,)) -> keep mask of the scores' shape. `valid`
    masks padded slots."""
    if scores.dim() == 1:
        return nms(boxes[None], scores[None], iou_threshold,
                   None if valid is None else valid[None])[0]
    if valid is not None:
        scores = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-scores, dim=-1, stable=True)
    b = _gather(boxes, order)
    live = _gather(scores, order) > float("-inf")
    n = scores.shape[-1]
    above = torch.ones(n, n, dtype=torch.bool, device=scores.device).triu(1)
    sup = ((box_iou(b, b) > iou_threshold) & above).float()   # (B, n, n)
    cnt = (~live).float()
    for i in range(n):
        cnt.addcmul_(sup[:, i], cnt[:, i:i + 1].eq(0))
    keep = torch.zeros_like(live)
    return keep.scatter_(1, order, cnt.eq(0))


def batched_pose_nms(boxes, scores, classes, keypoints,
                     iou_threshold: float = 0.45,
                     conf_threshold: float = 0.25,
                     max_det: int = 100,
                     class_offset: float = 7680.0,
                     pre_nms_topk: int = 512):
    """Pose NMS per image over a batch, with the class-offset trick
    (boxes shifted by class * 7680, so NMS is per class).

    boxes (B, N, 4) xyxy, scores (B, N), classes (B, N) int, keypoints
    (B, N, K, 3). Only the best `pre_nms_topk` candidates by score enter
    NMS. Returns fixed-size (B, max_det, ...) boxes, scores, classes
    (int32, -1 where invalid), keypoints (zeroed where invalid) and the
    valid mask."""
    n = scores.shape[-1]
    k = min(pre_nms_topk, n)
    if k < n:
        scores, sel = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
        scores, sel = scores[:, :k], sel[:, :k]
        boxes = _gather(boxes, sel)
        classes = _gather(classes, sel)
        keypoints = _gather(keypoints, sel)
    valid = scores >= conf_threshold
    off = classes.to(boxes.dtype)[..., None] * class_offset
    keep = nms(boxes + off, scores, iou_threshold, valid=valid)
    sel_scores = torch.where(keep, scores, -1.0)
    top = torch.argsort(-sel_scores, dim=-1, stable=True)[:, :max_det]
    top_scores = _gather(sel_scores, top)
    out_valid = top_scores > 0
    z = out_valid.to(boxes.dtype)
    return (_gather(boxes, top) * z[..., None],
            top_scores * z,
            torch.where(out_valid, _gather(classes, top).to(torch.int32),
                        -1),
            _gather(keypoints, top) * z[..., None, None],
            out_valid)
