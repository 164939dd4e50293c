"""v8DetectionLoss, v8PoseLoss and v8ClassificationLoss, the TAL-based
training path (counterpart of tpupose/losses/v8.py): DFL box decode, one
TaskAlignedAssigner pass, BCE class loss with the normalised alignment
as target, CIoU and DFL box losses on the positives; the pose loss adds
the keypoint decode (2v + anchor - 0.5) * stride, an OKS loss against
each positive's assigned GT keypoints and a BCE visibility loss. GTs
arrive padded (B, M) with a mask; positives stay dense (B, A), masked.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpupose_torch.losses.assigner import TaskAlignedAssigner
from tpupose_torch.losses.bbox import ciou, xywh2xyxy, xyxy2xywh
from tpupose_torch.losses.classify import (binary_cross_entropy_with_logits,
                                           cross_entropy)
from tpupose_torch.losses.keypoint import oks_loss
from tpupose_torch.losses.normalize import local_count
from tpupose_torch.models.yolo_head import dist2bbox, make_anchors


def dfl_loss(pred_dist, target_dist, reg_max: int = 16):
    """Distribution focal loss: CE against the two integer bins bracketing
    the target. pred_dist (..., 4, reg_max) logits; target_dist (..., 4)
    in [0, reg_max - 1]. Returns (...,), the mean over the 4 sides."""
    tl = torch.floor(target_dist).clamp(0, reg_max - 2).to(torch.int64)
    tr = tl + 1
    wl = tr.to(torch.float32) - target_dist
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist.to(torch.float32), dim=-1)
    ll = logp.gather(-1, tl[..., None])[..., 0]
    lr = logp.gather(-1, tr[..., None])[..., 0]
    return -(ll * wl + lr * wr).mean(-1)


class v8DetectionLoss:
    """TAL + BCE cls + CIoU/DFL box loss over multi-scale raw NHWC maps."""

    def __init__(self, num_classes: int, reg_max: int = 16,
                 strides: Sequence[int] = (8, 16, 32),
                 box_weight: float = 7.5, cls_weight: float = 0.5,
                 dfl_weight: float = 1.5, tal_topk: int = 10,
                 count=local_count):
        self.nc = num_classes
        self.count = count          # the normaliser of the score / positives
        self.reg_max = reg_max
        self.strides = tuple(strides)
        self.box_w, self.cls_w, self.dfl_w = box_weight, cls_weight, dfl_weight
        self.assigner = TaskAlignedAssigner(topk=tal_topk,
                                            num_classes=num_classes)

    def _flatten(self, preds):
        shapes = [tuple(p.shape[1:3]) for p in preds]
        anchors, strides = make_anchors(shapes, self.strides,
                                        device=preds[0].device)
        B = preds[0].shape[0]
        flat = torch.cat([p.reshape(B, -1, p.shape[-1]) for p in preds], 1)
        H0, W0 = shapes[0]
        in_wh = (W0 * self.strides[0], H0 * self.strides[0])
        return flat, anchors, strides, in_wh

    def _assign(self, flat, anchors, strides, in_wh, targets):
        R = self.reg_max
        cls_logits = flat[..., 4 * R: 4 * R + self.nc].to(torch.float32)
        B, A, _ = flat.shape
        d = flat[..., :4 * R].reshape(B, A, 4, R)
        p = torch.softmax(d.to(torch.float32), dim=-1)
        bins = torch.arange(R, dtype=torch.float32, device=flat.device)
        pd_boxes = dist2bbox((p * bins).sum(-1), anchors[None], xywh=False)
        in_w, in_h = in_wh
        scale = torch.tensor([in_w, in_h, in_w, in_h], dtype=torch.float32,
                             device=flat.device)
        gt_pix = xywh2xyxy(targets["boxes"].to(torch.float32) * scale)
        anc_pix = anchors * strides[:, None]
        pd_pix = pd_boxes * strides[None, :, None]
        _, tb, ts, fg, tgi = self.assigner(
            torch.sigmoid(cls_logits), pd_pix, anc_pix, targets["classes"],
            gt_pix, targets["instance_mask"].to(torch.float32))
        return {"cls_logits": cls_logits, "dist_raw": d, "pd_pix": pd_pix,
                "anchors": anchors, "strides": strides,
                "target_bboxes": tb, "target_scores": ts, "fg": fg,
                "target_gt_idx": tgi, "in_wh": in_wh,
                # (B,) per-image weight: the eval tail batch's padding rows
                # carry 0
                "sample_mask": targets.get("sample_mask")}

    def _det_losses(self, a):
        ts = a["target_scores"]
        ts_sum = self.count(ts.sum())
        cl = binary_cross_entropy_with_logits(a["cls_logits"], ts)
        if a["sample_mask"] is not None:
            cl = cl * a["sample_mask"].to(torch.float32)[:, None, None]
        loss_cls = cl.sum() / ts_sum

        w = ts.sum(-1) * a["fg"].to(torch.float32)
        iou = ciou(xyxy2xywh(a["pd_pix"]), xyxy2xywh(a["target_bboxes"]))
        loss_box = ((1.0 - iou) * w).sum() / ts_sum

        tb_grid = a["target_bboxes"] / a["strides"][None, :, None]
        anc = a["anchors"][None]
        t_ltrb = torch.cat([anc - tb_grid[..., :2], tb_grid[..., 2:] - anc],
                           -1).clamp(0, self.reg_max - 1.01)
        loss_dfl = (dfl_loss(a["dist_raw"], t_ltrb, self.reg_max)
                    * w).sum() / ts_sum
        return loss_box, loss_cls, loss_dfl

    def __call__(self, preds, targets):
        """preds: per-scale (B, H, W, 4 reg_max + nc) raw maps; targets:
        {"boxes" (B, M, 4) normalized xywh, "classes" (B, M),
        "instance_mask" (B, M)[, "sample_mask" (B,)]}."""
        a = self._assign(*self._flatten(preds), targets)
        loss_box, loss_cls, loss_dfl = self._det_losses(a)
        total = (self.box_w * loss_box + self.cls_w * loss_cls
                 + self.dfl_w * loss_dfl)
        return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl}


class v8PoseLoss(v8DetectionLoss):
    """The detection loss plus keypoint location and visibility losses on
    the TAL positives, from one assigner pass."""

    def __init__(self, num_keypoints: int, num_classes: int = 1,
                 kpt_weight: float = 12.0, vis_weight: float = 1.0, **kw):
        super().__init__(num_classes=num_classes, **kw)
        self.K = num_keypoints
        self.kpt_w = kpt_weight
        self.vis_w = vis_weight

    def __call__(self, preds, targets):
        """preds: per-scale (B, H, W, 4 reg_max + nc + 3K) raw maps;
        targets additionally hold "keypoints" (B, M, K, 3) normalized."""
        base_ch = 4 * self.reg_max + self.nc
        flat, anchors, strides, in_wh = self._flatten(preds)
        a = self._assign(flat, anchors, strides, in_wh, targets)
        loss_box, loss_cls, loss_dfl = self._det_losses(a)

        B, A, _ = flat.shape
        K = self.K
        kpt_raw = flat[..., base_ch:].reshape(B, A, K, 3).to(torch.float32)
        xy = (2.0 * kpt_raw[..., :2] + (anchors[None, :, None, :] - 0.5)) \
            * strides[None, :, None, None]
        in_w, in_h = in_wh
        gk = targets["keypoints"].to(torch.float32).gather(
            1, a["target_gt_idx"][:, :, None, None].expand(B, A, K, 3))
        gk_xy = gk[..., :2] * torch.tensor([in_w, in_h], dtype=torch.float32,
                                           device=flat.device)
        gk_vis = (gk[..., 2] > 0).to(torch.float32)
        tb = a["target_bboxes"]
        area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])) \
            .clamp_min(1e-3)
        fgf = a["fg"].to(torch.float32)
        kl = oks_loss(xy, gk_xy, gk_vis * fgf[..., None], area)
        npos = self.count(fgf.sum())
        loss_kpt = (kl * fgf).sum() / npos
        vis = binary_cross_entropy_with_logits(kpt_raw[..., 2], gk_vis)
        loss_vis = (vis.mean(-1) * fgf).sum() / npos
        total = (self.box_w * loss_box + self.cls_w * loss_cls
                 + self.dfl_w * loss_dfl + self.kpt_w * loss_kpt
                 + self.vis_w * loss_vis)
        return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl,
                       "kpt": loss_kpt, "vis": loss_vis}


class v8ClassificationLoss:
    """Plain softmax CE, averaged."""

    def __call__(self, logits, labels):
        loss = cross_entropy(logits, labels).mean()
        return loss, {"cls": loss}
