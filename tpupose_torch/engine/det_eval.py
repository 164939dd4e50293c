"""Detection-box-driven COCO keypoint evaluation, the official top-down
test protocol (the port's copy of tpupose/engine/det_eval.py).

GT-box evaluation (TopDownEvaluator.run over a CocoTopDownDataset) scores
pose quality alone; the number top-down papers report crops from a person
detector's boxes instead, so false positives, missed persons and box
noise flow into the score:

  detections JSON (COCO box-results format) -> fixed-aspect crops (the
  dataset's host crop, native or PIL) -> TopDownEvaluator.step on the
  device (on a SimpleBaseline-R50 at 256x192 the kernel route: K1-K3 and
  the DARK decode K4) -> per-image grouping on the host -> OKS-NMS ->
  OKS-AP greedy matching against the GT annotation file.

Each instance is rescored as detector box score x mean keypoint
confidence.
"""

from __future__ import annotations

import json
import os

import numpy as np

from tpupose_torch.data.coco import COCO_NUM_KEYPOINTS, CocoTopDownDataset
from tpupose_torch.utils.logging import printT, printW


class DetectionCropDataset(CocoTopDownDataset):
    """Top-down crops built from a COCO detection-results JSON.

    det_file entries: {image_id, category_id, bbox [x, y, w, h], score}.
    The annotation file supplies the image file names and the GT keypoint
    instances used for scoring (`gt_by_image`). Samples carry zero joints
    (this protocol has no per-crop GT) and the detector score under
    `det_score`.
    """

    def __init__(self, image_dir: str, ann_file: str, det_file: str,
                 image_size=(256, 192), heatmap_size=(64, 48),
                 num_keypoints: int = COCO_NUM_KEYPOINTS,
                 padding: float = 1.25, score_threshold: float = 0.0,
                 max_per_image: int = 100, decode_threads: int = 4,
                 flip_pairs=None, udp: bool = False):
        # the base class's crop machinery at eval settings; its keypoint
        # annotation parse is skipped: detections drive the samples
        super().__init__(image_dir, None, image_size=image_size,
                         heatmap_size=heatmap_size, is_train=False,
                         scale_factor=0.0, rotation_factor=0.0,
                         flip_prob=0.0, padding=padding,
                         decode_threads=decode_threads,
                         flip_pairs=flip_pairs, augment_geometry=False,
                         udp=udp)
        K = int(num_keypoints)
        with open(ann_file) as f:
            ann = json.load(f)
        img_info = {im["id"]: im for im in ann["images"]}

        # GT instances per image for OKS-AP. iscrowd GTs are skipped;
        # GTs without a visible keypoint are kept: OKSAP treats them as
        # COCO ignore regions (out of the recall denominator, detections
        # matched to them dropped from the ranking)
        self.gt_by_image: dict = {iid: [] for iid in img_info}
        n_crowd = 0
        for a in ann.get("annotations", []):
            if a.get("iscrowd", 0):
                n_crowd += 1
                continue
            kp = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
            x, y, w, h = a.get("bbox", [0, 0, 1, 1])
            self.gt_by_image[a["image_id"]].append((
                kp[:, :2], (kp[:, 2] > 0).astype(np.float32),
                float(a.get("area", w * h)),
                np.asarray([x, y, w, h], np.float32)))
        if n_crowd:
            printW(f"det-eval: skipped {n_crowd} iscrowd GT instances")

        with open(det_file) as f:
            dets = json.load(f)
        per_img: dict = {}
        for d in dets:
            if d.get("category_id", 1) != 1:
                continue
            if float(d.get("score", 1.0)) < score_threshold:
                continue
            if d["image_id"] not in img_info:
                continue
            per_img.setdefault(d["image_id"], []).append(d)

        self.samples = []
        for iid, ds in per_img.items():
            ds.sort(key=lambda d: -float(d.get("score", 1.0)))
            im = img_info[iid]
            for d in ds[:max_per_image]:
                x, y, w, h = [float(v) for v in d["bbox"]]
                if w <= 0 or h <= 0:
                    continue
                self.samples.append({
                    "file_name": im["file_name"],
                    "bbox": (x, y, w, h),
                    "joints": np.zeros((K, 2), np.float32),
                    "visibility": np.zeros(K, np.float32),
                    "area": float(w * h),
                    "image_id": int(iid),
                    "width": int(im.get("width", 0) or 0),
                    "height": int(im.get("height", 0) or 0),
                    "det_score": float(d.get("score", 1.0)),
                })
        printT(f"det-eval: {len(self.samples)} detections over "
               f"{len(per_img)} images ({len(img_info)} GT images)")


def evaluate_detections(evaluator, dataset: DetectionCropDataset,
                        batch_size: int = 64, sigmas=None,
                        rescore: bool = True, num_workers: int = 2,
                        results_path: str | None = None,
                        nms: str = "oks", nms_threshold: float = 0.9,
                        vis_threshold: float = 0.2) -> dict:
    """Run the detection-driven protocol; returns the COCO keypoint AP
    suite (mAP, mAP50, mAP75, AP_M, AP_L, AR...).

    evaluator: a TopDownEvaluator of the pose model (flip test, decode
    and udp set there). Each batch's step runs on the device and only its
    (B, K, 3) result comes back, copied to pinned host memory with an
    event, two batches in flight, as in TopDownEvaluator.run: no host
    sync per batch. Padded tail rows (pad_mask) are dropped. Images with
    GT and no detection still count their GTs (the recall denominator).

    nms: per-image instance dedup before scoring, "oks" (hard greedy at
    nms_threshold, the official protocol's default), "soft_oks"
    (Gaussian rescoring) or "none". vis_threshold gates the joints that
    enter the pairwise OKS. The OKS-NMS area is the crop scale's product
    (the padded, aspect-fitted box), not the detection box's area.
    """
    from collections import deque

    from tpupose_torch.data.loader import BatchLoader, to_device
    from tpupose_torch.metrics.oks_ap import OKSAP
    from tpupose_torch.ops.oks_nms import oks_nms, soft_oks_nms

    if nms not in ("oks", "soft_oks", "none"):
        raise ValueError(f"unknown det-eval nms {nms!r}")
    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                         pad_last=True, num_workers=num_workers)
    groups: dict = {}
    results: list = []

    def accumulate(host, done, batch):
        if done is not None:
            done.synchronize()
        res = host.numpy()
        coords, scores = res[..., :2], res[..., 2]
        keep = np.asarray(batch["pad_mask"]).astype(bool) \
            if "pad_mask" in batch else np.ones(len(coords), bool)
        coords, scores = coords[keep], scores[keep]
        ids = np.asarray(batch["image_id"]).reshape(-1)[keep]
        det = np.asarray(batch["det_score"], np.float32).reshape(-1)[keep]
        sc = np.asarray(batch["scale"], np.float32).reshape(-1, 2)[keep]
        area = sc[:, 0] * sc[:, 1]
        inst = det * scores.mean(axis=-1) if rescore else det
        for i in range(len(coords)):
            groups.setdefault(int(ids[i]), []).append(
                (coords[i], float(inst[i]), scores[i], float(area[i])))

    inflight: deque = deque()
    for batch in loader:
        dev = to_device({k: batch[k] for k in ("images", "center", "scale")},
                        evaluator.device)
        coords, scores = evaluator.step(dev["images"], dev["center"],
                                        dev["scale"])
        inflight.append((*evaluator._fetch(coords, scores), batch))
        while len(inflight) > 2:
            accumulate(*inflight.popleft())
    while inflight:
        accumulate(*inflight.popleft())

    K = dataset.samples[0]["joints"].shape[0] if dataset.samples \
        else COCO_NUM_KEYPOINTS
    ap = OKSAP(num_classes=1, sigmas=sigmas)
    for iid, gts in dataset.gt_by_image.items():
        preds = groups.get(iid, [])
        if preds and nms != "none":
            pk_all = np.stack([p[0] for p in preds])
            ps_all = np.asarray([p[1] for p in preds], np.float32)
            ks_all = np.stack([p[2] for p in preds])
            ar_all = np.asarray([p[3] for p in preds], np.float32)
            if nms == "soft_oks":
                keep, ps_kept = soft_oks_nms(
                    pk_all, ps_all, ar_all, sigmas=sigmas, kscores=ks_all,
                    vis_threshold=vis_threshold)
                preds = [(preds[j][0], float(s), preds[j][2], preds[j][3])
                         for j, s in zip(keep, ps_kept)]
            else:
                keep = oks_nms(pk_all, ps_all, ar_all,
                               threshold=nms_threshold, sigmas=sigmas,
                               kscores=ks_all, vis_threshold=vis_threshold)
                preds = [preds[j] for j in keep]
        if results_path is not None:
            for c, s, kscore, _a in preds:
                kp = np.concatenate([c, np.asarray(kscore)[:, None]], -1)
                results.append({
                    "image_id": int(iid), "category_id": 1,
                    "keypoints": [round(float(v), 3) for v in kp.reshape(-1)],
                    "score": round(float(s), 5)})
        pk = (np.stack([p[0] for p in preds]) if preds
              else np.zeros((0, K, 2), np.float32))
        ps = np.asarray([p[1] for p in preds], np.float32)
        if gts:
            gk = np.stack([g[0] for g in gts])
            gv = np.stack([g[1] for g in gts])
            ga = np.asarray([g[2] for g in gts], np.float32)
            gb = np.stack([g[3] for g in gts])
        else:
            gk = np.zeros((0, K, 2), np.float32)
            gv = np.zeros((0, K), np.float32)
            ga = np.zeros(0, np.float32)
            gb = np.zeros((0, 4), np.float32)
        if len(pk) == 0 and len(gk) == 0:
            continue
        ap.update(pk, ps, gk, gv, ga, gt_bbox=gb)
    if results_path is not None:
        d = os.path.dirname(results_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(results_path, "w") as f:
            json.dump(results, f)
    return {k: float(v) for k, v in ap.compute().items()
            if np.isscalar(v) or isinstance(v, float)}
