"""DetectionMAP, COCO-style box mAP (the port's copy of
tpupose/metrics/det_map.py): per-image GT and prediction accumulation,
per-class per-IoU greedy matching, precision-envelope AP over 101 recall
points. Host numpy.
"""

from __future__ import annotations

import numpy as np


def box_iou_np(a, b):
    """(N,4) x (M,4) xyxy -> (N,M) IoU, numpy."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    ab = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


class DetectionMAP:
    def __init__(self, num_classes: int = 1, thresholds=None):
        self.num_classes = num_classes
        self.thresholds = np.asarray(
            thresholds if thresholds is not None else np.arange(0.50, 1.0, 0.05))
        self.reset()

    def reset(self):
        self._images = []  # (pred_boxes, scores, pred_cls, gt_boxes, gt_cls)

    def update(self, pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls,
               pred_valid=None, gt_valid=None):
        pb, ps, pc = map(np.asarray, (pred_boxes, pred_scores, pred_cls))
        gb, gc = np.asarray(gt_boxes), np.asarray(gt_cls)
        if pred_valid is not None:
            m = np.asarray(pred_valid, bool)
            pb, ps, pc = pb[m], ps[m], pc[m]
        if gt_valid is not None:
            m = np.asarray(gt_valid, bool)
            gb, gc = gb[m], gc[m]
        self._images.append((pb, ps, pc, gb, gc))

    def _ap(self, c, thr):
        scores_all, tps = [], []
        n_gt = 0
        for pb, ps, pc, gb, gc in self._images:
            gsel = gc == c
            n_gt += int(gsel.sum())
            psel = pc == c
            if not psel.any():
                continue
            iou = box_iou_np(pb[psel], gb[gsel])
            order = np.argsort(-ps[psel])
            taken = np.zeros(iou.shape[1], bool)
            for i in order:
                scores_all.append(ps[psel][i])
                if iou.shape[1] == 0:
                    tps.append(False)
                    continue
                row = np.where(taken, -1.0, iou[i])
                j = int(np.argmax(row))
                if row[j] >= thr:
                    taken[j] = True
                    tps.append(True)
                else:
                    tps.append(False)
        if n_gt == 0 or not scores_all:
            return 0.0 if n_gt else np.nan
        order = np.argsort(-np.asarray(scores_all))
        t = np.asarray(tps)[order]
        tp = np.cumsum(t)
        fp = np.cumsum(~t)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        rc = np.linspace(0, 1, 101)
        idx = np.searchsorted(recall, rc, side="left")
        prec = np.where(idx < len(precision),
                        precision[np.minimum(idx, len(precision) - 1)], 0.0)
        return float(prec.mean())

    def compute(self) -> dict:
        table = np.array([[self._ap(c, t) for t in self.thresholds]
                          for c in range(self.num_classes)])
        valid = ~np.all(np.isnan(table), axis=1)
        table = np.nan_to_num(table)
        if not valid.any():
            return {"mAP": 0.0, "mAP50": 0.0, "mAP75": 0.0, "per_class": table}
        m = table[valid].mean(axis=0)
        i50 = int(np.argmin(np.abs(self.thresholds - 0.5)))
        i75 = int(np.argmin(np.abs(self.thresholds - 0.75)))
        return {"mAP": float(m.mean()), "mAP50": float(m[i50]),
                "mAP75": float(m[i75]), "per_class": table.mean(axis=1)}
