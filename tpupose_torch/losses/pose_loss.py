"""ComputeLoss, the centre-cell assigner loss that trains the single-stage
YOLO-pose model (counterpart of tpupose/losses/pose_loss.py). Per scale:

  - the cell holding a GT box's centre is that instance's positive;
  - box and keypoint offsets are relative to that cell, in grid units;
  - an OKS-family keypoint loss and a BCE visibility loss on positives;
  - the class target is the detached, clamped CIoU of the box spanned by
    the predicted keypoints against the GT box, a soft quality score
    scattered into a (B, H*W, nc) map (instances sharing a cell and class
    keep the larger score), scored by VarifocalLoss over every cell;
  - weights cls 1 / kpt 10 / vis 5, each normalised once by the number
    of positives.

GTs arrive padded to (B, M) with an instance mask; positives are gathered
with `torch.gather` and everything else is masked arithmetic, with no
host sync.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpupose_torch.losses.bbox import ciou, kpts_to_box
from tpupose_torch.losses.classify import (binary_cross_entropy_with_logits,
                                           varifocal_loss)
from tpupose_torch.losses.keypoint import get_kpt_loss
from tpupose_torch.losses.normalize import local_count


class ComputeLoss:
    def __init__(self, num_keypoints: int, num_classes: int = 1,
                 strides: Sequence[int] = (8, 16, 32),
                 kpt_loss_type: str = "hybrid",
                 cls_weight: float = 1.0, kpt_weight: float = 10.0,
                 vis_weight: float = 5.0, use_varifocal: bool = True,
                 count=local_count):
        self.K = num_keypoints
        self.count = count          # the positives' normaliser
        self.nc = num_classes
        self.strides = tuple(strides)
        self.kpt_loss = get_kpt_loss(kpt_loss_type)
        self.cls_weight = cls_weight
        self.kpt_weight = kpt_weight
        self.vis_weight = vis_weight
        self.use_varifocal = use_varifocal
        self.set_train_loss()

    # the running sums of the reference's loss-accumulation API
    def set_train_loss(self):
        self._sums = {"cls": 0.0, "kpt": 0.0, "vis": 0.0, "n": 0}

    def add_loss(self, parts):
        for k in ("cls", "kpt", "vis"):
            self._sums[k] += float(parts[k])
        self._sums["n"] += 1

    def mean_loss(self):
        n = max(self._sums["n"], 1)
        return {k: v / n for k, v in self._sums.items() if k != "n"}

    def _one_scale(self, pred, targets):
        """pred: (B, H, W, nc + 3K) raw map. Returns partial sums."""
        B, H, W, C = pred.shape
        K, nc = self.K, self.nc
        boxes = targets["boxes"].to(torch.float32)        # (B, M, 4) cxcywh
        kpts = targets["keypoints"].to(torch.float32)     # (B, M, K, 3)
        cls_idx = targets["classes"].to(torch.int64)      # (B, M)
        imask = targets["instance_mask"].to(torch.float32)
        M = boxes.shape[1]

        gscale = torch.tensor([W, H, W, H], dtype=torch.float32,
                              device=pred.device)
        gbox = boxes * gscale
        gkx = kpts[..., 0] * W
        gky = kpts[..., 1] * H
        kvis = (kpts[..., 2] > 0).to(torch.float32) * imask[..., None]
        gx = gbox[..., 0].to(torch.int64).clamp(0, W - 1)           # (B, M)
        gy = gbox[..., 1].to(torch.int64).clamp(0, H - 1)

        # positives: the raw channels at each instance's centre cell
        flat = pred.reshape(B, H * W, C)
        cell = gy * W + gx
        ppos = flat.gather(1, cell[..., None].expand(B, M, C))
        pk = ppos[..., nc:].reshape(B, M, K, 3).to(torch.float32)
        pk_xy, pk_vis = pk[..., :2], pk[..., 2]
        gxf, gyf = gx.to(torch.float32), gy.to(torch.float32)
        gt_xy = torch.stack([gkx - gxf[..., None], gky - gyf[..., None]], -1)
        gt_box_off = torch.cat([(gbox[..., 0] - gxf)[..., None],
                                (gbox[..., 1] - gyf)[..., None],
                                gbox[..., 2:4]], -1)
        area = gbox[..., 2] * gbox[..., 3]

        loss_kpt = (self.kpt_loss(pk_xy, gt_xy, kvis, area) * imask).sum()
        vis_bce = binary_cross_entropy_with_logits(pk_vis, kvis)
        loss_vis = (vis_bce * imask[..., None]).sum()

        # soft class target: detached CIoU of the keypoint-derived box
        quality = ciou(kpts_to_box(pk_xy, kvis), gt_box_off).clamp(0.0, 1.0)
        quality = torch.nan_to_num(quality.detach()) * imask
        tgt = torch.zeros((B, H * W * nc), dtype=torch.float32,
                          device=pred.device)
        tgt.scatter_reduce_(1, cell * nc + cls_idx, quality, "amax")
        tgt = tgt.reshape(B, H * W, nc)

        pred_cls = flat[..., :nc].to(torch.float32)
        label = (tgt > 0).to(torch.float32)
        if self.use_varifocal:
            cl = varifocal_loss(pred_cls, tgt, label)
        else:
            cl = binary_cross_entropy_with_logits(pred_cls, tgt)
        # per-image weight: the eval tail batch's padding rows carry 0
        smask = targets.get("sample_mask")
        if smask is not None:
            cl = cl * smask.to(torch.float32)[:, None, None]
        return cl.sum(), loss_kpt, loss_vis, imask.sum()

    def __call__(self, preds, targets):
        """preds: the per-scale raw NHWC maps (the train-mode head output).
        targets: {"boxes" (B, M, 4) normalized xywh, "classes" (B, M),
        "keypoints" (B, M, K, 3) normalized, "instance_mask" (B, M)[,
        "sample_mask" (B,)]}. Returns (total, {"cls", "kpt", "vis"})."""
        tc = tk = tv = npos = 0.0
        for pred in preds:
            c, k, v, n = self._one_scale(pred, targets)
            tc, tk, tv, npos = tc + c, tk + k, tv + v, npos + n
        denom = self.count(npos)
        loss_cls = tc / denom * self.cls_weight
        loss_kpt = tk / denom * self.kpt_weight
        loss_vis = tv / denom * self.vis_weight
        total = loss_cls + loss_kpt + loss_vis
        return total, {"cls": loss_cls, "kpt": loss_kpt, "vis": loss_vis}
