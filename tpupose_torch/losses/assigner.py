"""TaskAlignedAssigner, YOLOv8's TAL as dense (B, M, A) tensor arithmetic
(counterpart of tpupose/losses/assigner.py): anchors inside a GT box are
candidates, the alignment metric is s^alpha * IoU^beta, each GT takes
its top-k anchors, an anchor claimed by several GTs keeps the one of
highest IoU, and the class targets are the alignment normalised by each
GT's best IoU over its best alignment.

Ties are resolved as in JAX: the top-k is a stable descending sort (the
lower anchor index first among equal metrics, as `jax.lax.top_k`, where
`torch.topk` promises no order), and the argmaxes take the first
maximum. Ties are common: at the prior-probability init every class
score is equal, and the metric is exactly 0 outside the boxes. As in
JAX, gradients flow through the target scores; the maxima are `amax`,
which shares the gradient between ties as JAX's max does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpupose_torch.losses.bbox import pairwise_iou_xyxy


class TaskAlignedAssigner:
    def __init__(self, topk: int = 10, num_classes: int = 80,
                 alpha: float = 1.0, beta: float = 6.0, eps: float = 1e-9):
        self.topk = topk
        self.num_classes = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels,
                 gt_bboxes, mask_gt):
        """pd_scores (B, A, nc) post-sigmoid; pd_bboxes (B, A, 4) xyxy;
        anc_points (A, 2); gt_labels (B, M) int; gt_bboxes (B, M, 4) xyxy;
        mask_gt (B, M). Returns target_labels (B, A), target_bboxes
        (B, A, 4), target_scores (B, A, nc), fg_mask (B, A) bool and
        target_gt_idx (B, A)."""
        B, A, nc = pd_scores.shape
        M = gt_labels.shape[1]
        gt_labels = gt_labels.to(torch.int64)
        mask_gt = mask_gt.to(torch.float32)

        # 1) anchors strictly inside the GT boxes
        lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]
        rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
        mask_in_gts = (torch.minimum(lt.amin(-1), rb.amin(-1)) > self.eps)
        mask_in_gts = mask_in_gts.to(torch.float32) * mask_gt[..., None]

        # 2) the alignment metric
        ious = pairwise_iou_xyxy(gt_bboxes, pd_bboxes).clamp(0.0, 1.0) \
            * mask_in_gts                                          # (B,M,A)
        cls_idx = gt_labels.clamp(0, nc - 1)
        sc = pd_scores.transpose(1, 2).gather(
            1, cls_idx[..., None].expand(B, M, A))
        align = sc.pow(self.alpha) * ious.pow(self.beta) * mask_in_gts

        # 3) top-k anchors per GT (stable: ties go to the lower index)
        k = min(self.topk, A)
        topv, topi = torch.sort(align.detach(), dim=-1, descending=True,
                                stable=True)
        topv, topi = topv[..., :k], topi[..., :k]
        valid = (topv > self.eps).to(torch.float32)
        mask_topk = torch.zeros_like(align).scatter_add_(-1, topi, valid)
        mask_pos = (mask_topk > 0).to(torch.float32) * mask_in_gts

        # 4) an anchor claimed by several GTs keeps the highest-IoU one
        n_claims = mask_pos.sum(1, keepdim=True)
        best_gt = ious.argmax(1)                                   # (B, A)
        best_onehot = F.one_hot(best_gt, M).transpose(1, 2) \
            .to(torch.float32)
        mask_pos = torch.where(n_claims > 1, best_onehot * mask_pos, mask_pos)

        fg_mask = mask_pos.sum(1) > 0
        target_gt_idx = mask_pos.argmax(1)

        # 5) targets from the assigned GT
        tl = gt_labels.gather(1, target_gt_idx)
        target_labels = torch.where(fg_mask, tl,
                                    torch.full_like(tl, self.num_classes))
        target_bboxes = gt_bboxes.gather(
            1, target_gt_idx[..., None].expand(B, A, 4))
        align_pos = align * mask_pos
        pos_align_max = align_pos.amax(-1, keepdim=True)
        pos_iou_max = (ious * mask_pos).amax(-1, keepdim=True)
        norm = align_pos * pos_iou_max / (pos_align_max + self.eps)
        score_val = norm.amax(1)
        onehot_lbl = F.one_hot(target_labels.clamp(0, nc - 1), nc) \
            .to(torch.float32)
        target_scores = onehot_lbl * (score_val * fg_mask)[..., None]
        return (target_labels, target_bboxes, target_scores, fg_mask,
                target_gt_idx)
