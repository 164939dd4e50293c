"""OKS + OKS-AP, the COCO keypoint mAP (the port's copy of
tpupose/metrics/oks_ap.py).

Per-instance OKS exp(-d^2 / (2 * area * (2*sigma)^2)) over visible
joints, batch accumulation, per-class x per-threshold AP over
0.50:0.05:0.95 with precision-envelope integration, returning
mAP/mAP50/mAP75/per-class, and the rest of the COCO keypoint suite:
AP_M/AP_L (medium 32^2<area<96^2 / large area>96^2, with out-of-range
GTs treated as COCO "ignore" regions: detections that match only an
ignored GT are dropped from the ranking rather than counted as false
positives) and average recall AR/AR50/AR75/AR_M/AR_L.

The OKS matrix is computed on the host in float32 numpy, the precision
of the JAX package's jnp default (float64 would move threshold
decisions); matching and AP integration run in numpy over the
accumulated (small) lists, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

# COCO-17 keypoint sigmas (reference: HPE/core/metric/__init__.py:13-18)
OKS_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
], dtype=np.float32)


def default_sigmas(num_keypoints: int) -> np.ndarray:
    """Per-joint OKS sigmas: the COCO-17 table when it applies, a flat
    0.05 otherwise. Shared by AP scoring and OKS-NMS so the two always
    use the same OKS definition."""
    if num_keypoints <= 17:
        return OKS_SIGMAS[:num_keypoints]
    return np.full(num_keypoints, 0.05, np.float32)


def compute_oks(pred_kpts, gt_kpts, gt_vis, gt_area, sigmas=None):
    """OKS between prediction/GT instance pairs.

    pred_kpts: (N, K, 2), gt_kpts: (M, K, 2), gt_vis: (M, K),
    gt_area: (M,) -> (N, M) float32 OKS matrix.
    """
    pred_kpts = np.asarray(pred_kpts, np.float32)
    gt_kpts = np.asarray(gt_kpts, np.float32)
    K = pred_kpts.shape[-2]
    if sigmas is None:
        sigmas = default_sigmas(K)
    sig = np.asarray(sigmas, np.float32)
    d2 = np.sum(
        (pred_kpts[:, None, :, :] - gt_kpts[None, :, :, :]) ** 2, axis=-1
    )  # (N, M, K)
    var = (np.float32(2.0) * sig) ** 2  # (K,)
    area = np.maximum(np.asarray(gt_area, np.float32),
                      np.float32(1e-6))[None, :, None]
    e = d2 / (np.float32(2.0) * area * var[None, None, :])
    vis = (np.asarray(gt_vis) > 0).astype(np.float32)[None, :, :]
    num = np.sum(np.exp(-e) * vis, axis=-1)
    den = np.maximum(np.sum(vis, axis=-1), np.float32(1e-9))
    oks = num / den
    # instances with no visible joints get OKS 0 here; OKSAP.update
    # overrides such rows with the bbox-proximity fallback when the GT
    # boxes are available (pycocotools' k1==0 branch)
    return np.where(np.sum(vis, axis=-1) > 0, oks, np.float32(0.0))


def _bbox_fallback_oks(pred_kpts, gt_bbox, gt_area, sigmas):
    """pycocotools' zero-visible-GT OKS: per-joint distance to the GT box
    inflated 2x (zero inside), averaged over ALL joints. Lets detections
    overlapping an unannotated person match (and be ignored against) it.
    pred_kpts (N, K, 2), gt_bbox (x, y, w, h) -> (N,) OKS vs that GT."""
    x, y, w, h = [float(v) for v in gt_bbox]
    x0, x1 = x - w, x + 2 * w
    y0, y1 = y - h, y + 2 * h
    xd, yd = pred_kpts[..., 0], pred_kpts[..., 1]
    dx = np.maximum(0.0, x0 - xd) + np.maximum(0.0, xd - x1)
    dy = np.maximum(0.0, y0 - yd) + np.maximum(0.0, yd - y1)
    var = (2.0 * np.asarray(sigmas, np.float64)) ** 2
    e = (dx ** 2 + dy ** 2) / var[None, :] / (max(float(gt_area), 1e-6)
                                              + np.spacing(1)) / 2.0
    return np.exp(-e).mean(axis=-1)


class OKSAP:
    """COCO-style keypoint AP with accumulate/compute/reset."""

    def __init__(self, num_classes: int = 1, thresholds=None, sigmas=None,
                 max_dets: int = 20):
        """max_dets: per-image detection cap before ranking — the COCO
        keypoint protocol evaluates AP/AR @ maxDets=20; pass a larger
        value only to reproduce non-standard reports."""
        self.num_classes = num_classes
        self.thresholds = np.asarray(
            thresholds if thresholds is not None else np.arange(0.50, 1.0, 0.05)
        )
        self.sigmas = sigmas
        self.max_dets = int(max_dets)
        self.reset()

    # COCO keypoint area ranges: (label, lo, hi)
    AREA_RANGES = (("all", 0.0, 1e10),
                   ("M", 32.0 ** 2, 96.0 ** 2),
                   ("L", 96.0 ** 2, 1e10))

    def reset(self):
        # per class: list of (scores, oks rows vs gts in that image,
        # gt areas, pred areas, gt base-ignore flags) — areas drive the
        # M/L range splits; base-ignore marks zero-visible-keypoint GTs
        # (COCO ignore regions, excluded from the recall denominator)
        self._preds = [[] for _ in range(self.num_classes)]
        self._num_gt = np.zeros(self.num_classes, np.int64)

    def update(self, pred_kpts, pred_scores, gt_kpts, gt_vis, gt_area,
               pred_cls=None, gt_cls=None, pred_valid=None, gt_valid=None,
               pred_area=None, gt_bbox=None):
        """Accumulate one image.

        pred_kpts (N,K,2), pred_scores (N,), gt_kpts (M,K,2), gt_vis (M,K),
        gt_area (M,); optional class ids and padding masks. pred_area (N,)
        drives the COCO rule that an UNMATCHED detection whose own area is
        outside the evaluated range is ignored rather than an FP; when not
        given it is approximated by the predicted-keypoint bounding box
        over non-sentinel joints. gt_bbox (M, 4) xywh enables the
        pycocotools bbox-proximity OKS for zero-visible GTs (detections
        over an unannotated person are ignored rather than FPs).

        GTs with no visible joint are COCO "ignore" regions: never in the
        recall denominator; a detection whose only match is one is dropped
        from the ranking. Only the top max_dets detections per image are
        kept (COCO keypoints evaluates @ maxDets=20).
        """
        pred_kpts = np.asarray(pred_kpts)
        pred_scores = np.asarray(pred_scores)
        gt_kpts = np.asarray(gt_kpts)
        gt_vis = np.asarray(gt_vis)
        gt_area = np.asarray(gt_area)
        N, M = pred_kpts.shape[0], gt_kpts.shape[0]
        pred_cls = np.zeros(N, np.int64) if pred_cls is None else np.asarray(pred_cls)
        gt_cls = np.zeros(M, np.int64) if gt_cls is None else np.asarray(gt_cls)
        pred_valid = np.ones(N, bool) if pred_valid is None else np.asarray(pred_valid, bool)
        gt_valid = np.ones(M, bool) if gt_valid is None else np.asarray(gt_valid, bool)
        if pred_area is None:
            # bbox over real joints only: decode sentinels ((-1,-1) /
            # negative back-projections) would anchor the span far off
            # the person and corrupt the M/L ignore decision
            good = (pred_kpts >= 0).all(axis=-1)              # (N, K)
            big = 1e9
            lo = np.where(good[..., None], pred_kpts, big).min(axis=1)
            hi = np.where(good[..., None], pred_kpts, -big).max(axis=1)
            span = np.where(good.any(-1)[:, None], hi - lo, 0.0)
            pred_area = span[:, 0] * span[:, 1]
        pred_area = np.asarray(pred_area, np.float64)

        oks = (compute_oks(pred_kpts, gt_kpts, gt_vis, gt_area, self.sigmas)
               if N and M else np.zeros((N, M), np.float32))
        gt_ig = (gt_vis > 0).sum(axis=-1) == 0 if M else np.zeros(0, bool)
        if gt_bbox is not None and N and M:
            K = pred_kpts.shape[1]
            sig = (self.sigmas if self.sigmas is not None
                   else default_sigmas(K))
            for j in np.flatnonzero(gt_ig):
                oks[:, j] = _bbox_fallback_oks(pred_kpts, gt_bbox[j],
                                               gt_area[j], sig)

        for c in range(self.num_classes):
            gsel = gt_valid & (gt_cls == c)
            self._num_gt[c] += int((gsel & ~gt_ig).sum())
            psel = pred_valid & (pred_cls == c)
            if not psel.any() and not gsel.any():
                continue
            scores_c = pred_scores[psel]
            keep = np.argsort(-scores_c)[: self.max_dets]
            rows = (oks[psel][:, gsel] if gsel.any()
                    else np.zeros((int(psel.sum()), 0)))
            self._preds[c].append(
                (scores_c[keep], rows[keep],
                 gt_area[gsel].astype(np.float64),
                 pred_area[psel][keep], gt_ig[gsel]))

    def _pr_for_class(self, c: int, area_rng=(0.0, 1e10)):
        """Greedy matching per threshold + 101-pt precision envelope AP.

        area_rng restricts evaluation to GTs with lo <= area < hi; GTs
        outside the range are COCO "ignore" regions — a detection whose
        best remaining match is an ignored GT at or above the threshold is
        removed from the ranking (neither TP nor FP).
        Returns (aps, recalls), each (len(thresholds),); all-NaN when the
        class has NO GT in the range (pycocotools excludes such ranges
        and reports -1, not 0 — compute() nanmeans and maps to -1).
        """
        lo, hi = area_rng
        entries = self._preds[c]
        nthr = len(self.thresholds)
        n_gt = sum(int((~ig & (a >= lo) & (a < hi)).sum())
                   for _, _, a, _, ig in entries)
        if not entries or n_gt == 0:
            return np.full(nthr, np.nan), np.full(nthr, np.nan)
        aps = np.zeros(nthr)
        recalls = np.zeros(nthr)
        # flatten detections keeping per-image gt association
        for ti, thr in enumerate(self.thresholds):
            scores_all, tps = [], []
            for scores, oks_rows, areas, pareas, ig_base in entries:
                order = np.argsort(-scores)
                # a GT is ignored when it has no visible joints OR its
                # area is outside the evaluated range (pycocotools gtIg)
                gt_ig = ig_base | ~((areas >= lo) & (areas < hi))
                p_in_rng = (pareas >= lo) & (pareas < hi)
                taken = np.zeros(oks_rows.shape[1], bool)
                for i in order:
                    row = oks_rows[i] if oks_rows.shape[1] else np.zeros(0)
                    free = ~taken & (row >= thr)
                    primary = free & ~gt_ig
                    if primary.any():
                        j = int(np.argmax(np.where(primary, row, -1.0)))
                        taken[j] = True
                        scores_all.append(scores[i])
                        tps.append(True)
                    elif free.any():
                        # best remaining match is an ignored GT: mark it
                        # taken (one det per GT, like pycocotools' gtm for
                        # non-crowd ignores) and drop the det from ranking
                        j = int(np.argmax(np.where(free, row, -1.0)))
                        taken[j] = True
                        continue
                    elif not p_in_rng[i]:
                        # unmatched det whose own area is outside the range
                        continue
                    else:
                        scores_all.append(scores[i])
                        tps.append(False)
            scores_all = np.asarray(scores_all)
            tps = np.asarray(tps, bool)
            if scores_all.size == 0:
                continue
            order = np.argsort(-scores_all)
            tp = np.cumsum(tps[order])
            fp = np.cumsum(~tps[order])
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1)
            recalls[ti] = recall[-1]
            # precision envelope (monotone decreasing)
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            # 101-point interpolation (COCO)
            rc = np.linspace(0, 1, 101)
            idx = np.searchsorted(recall, rc, side="left")
            prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
            aps[ti] = prec_at.mean()
        return aps, recalls

    def compute(self) -> dict:
        pr = {label: [self._pr_for_class(c, (lo, hi))
                      for c in range(self.num_classes)]
              for label, lo, hi in self.AREA_RANGES}
        per_class = np.stack([ap for ap, _ in pr["all"]])
        valid = self._num_gt > 0
        if not valid.any():
            # same schema as the normal path, everything at COCO's
            # 'not evaluated' sentinel
            out = {k: -1.0 for k in ("mAP", "mAP50", "mAP75", "AP_M",
                                     "AP_L", "AR", "AR50", "AR75",
                                     "AR_M", "AR_L")}
            out["per_class"] = np.full(self.num_classes, -1.0)
            return out
        i50 = int(np.argmin(np.abs(self.thresholds - 0.5)))
        i75 = int(np.argmin(np.abs(self.thresholds - 0.75)))

        def nanmean(a, axis=None):
            """np.nanmean without the all-NaN RuntimeWarning: NaN (not a
            warning) when every element along `axis` is NaN."""
            m = np.isfinite(a)
            s = np.where(m, a, 0.0).sum(axis)
            c = m.sum(axis)
            return np.where(c > 0, s / np.maximum(c, 1), np.nan)

        def mean_over(label, which):
            """Mean over valid classes, NaN-excluding classes with no GT
            in the range (pycocotools semantics)."""
            vals = np.stack([pr[label][c][which]
                             for c in range(self.num_classes)])[valid]
            return nanmean(vals, axis=0)

        def scalar(x):
            """-1.0 when NO class had a GT in the range (COCO's 'not
            evaluated' marker), else the float value."""
            v = float(x)
            return -1.0 if np.isnan(v) else v

        ap_all = mean_over("all", 0)
        ar_all = mean_over("all", 1)
        return {
            "mAP": scalar(nanmean(ap_all)),
            "mAP50": scalar(ap_all[i50]),
            "mAP75": scalar(ap_all[i75]),
            "AP_M": scalar(nanmean(mean_over("M", 0))),
            "AP_L": scalar(nanmean(mean_over("L", 0))),
            "AR": scalar(nanmean(ar_all)),
            "AR50": scalar(ar_all[i50]),
            "AR75": scalar(ar_all[i75]),
            "AR_M": scalar(nanmean(mean_over("M", 1))),
            "AR_L": scalar(nanmean(mean_over("L", 1))),
            # classes with no GT anywhere report -1 (excluded from mAP)
            "per_class": np.where(np.isnan(per_class).all(axis=1), -1.0,
                                  np.nan_to_num(per_class).mean(axis=1)),
        }
