"""Inference / visualization CLI (counterpart of tpupose/cli/test.py):
load weights -> resize -> forward -> NMS or AE grouping -> rescale the
keypoints -> draw, writing each annotated image under its input's name.

    python -m tpupose_torch.cli.test --cfg cfg.yaml [--ckpt dir[@best]] \
        images_dir=folder/ output_dir=viz/ [--device cuda]

A single-stage config (DINOv3Pose) runs YoloPosePredictor's pipeline:
the images load on two threads and the device work of the next images
is queued before earlier results are drawn, strictly in order. A
`bottom_up` config runs BottomUpPredictor (forward + AE grouping on the
device). `eval.int8` serves through the PTQ intercept calibrated on the
first image. Without `--ckpt` the model keeps the builder's seeded init
(a warning says so). `--device` defaults to cuda and raises where CUDA
is absent. `draw_detections` (and its two skeletons) also draws for
`cli.video`.
"""

from __future__ import annotations

import glob
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpupose_torch.configs import default_config, parse_args, update_config
from tpupose_torch.utils.logging import printS, printT, printW

# skeleton for the reference's 4-kpt object poses: 0-1-2-3-0 + midline
# (HPE/test.py:189-277 draw_detections)
DEFAULT_SKELETON_4 = ((0, 1), (1, 2), (2, 3), (3, 0))

# COCO-17 person skeleton (limbs by keypoint index)
COCO_SKELETON_17 = ((15, 13), (13, 11), (16, 14), (14, 12), (11, 12),
                    (5, 11), (6, 12), (5, 6), (5, 7), (6, 8), (7, 9),
                    (8, 10), (1, 2), (0, 1), (0, 2), (1, 3), (2, 4),
                    (3, 5), (4, 6))


def draw_detections(image, keypoints, scores, valid, skeleton=None, radius=3):
    """Pure-NumPy renderer: dots + skeleton lines onto an RGB uint8 image."""
    img = image.copy()
    H, W = img.shape[:2]
    K = keypoints.shape[1]
    if skeleton is None:
        skeleton = (DEFAULT_SKELETON_4 if K == 4
                    else COCO_SKELETON_17 if K == 17 else ())

    def dot(x, y, color):
        x, y = int(round(x)), int(round(y))
        if 0 <= x < W and 0 <= y < H:
            y0, y1 = max(0, y - radius), min(H, y + radius + 1)
            x0, x1 = max(0, x - radius), min(W, x + radius + 1)
            img[y0:y1, x0:x1] = color

    def line(p, q, color):
        n = int(max(abs(q[0] - p[0]), abs(q[1] - p[1]), 1))
        for t in np.linspace(0, 1, n * 2):
            dot(p[0] + (q[0] - p[0]) * t, p[1] + (q[1] - p[1]) * t, color)

    for i in range(keypoints.shape[0]):
        if not valid[i]:
            continue
        kps = keypoints[i]
        for a, b in skeleton:
            if kps[a, 2] > 0.5 and kps[b, 2] > 0.5:
                line(kps[a, :2], kps[b, :2], (0, 255, 0))
        for k in range(K):
            if kps[k, 2] > 0.5:
                dot(kps[k, 0], kps[k, 1], (255, 0, 0))
    return img


def run_inference(cfg, images_dir: str, output_dir: str, weights: str = "",
                  device="cuda"):
    """Annotate every *.jpg / *.jpeg / *.png of `images_dir` (sorted) into
    `output_dir`. Returns {"images": count, "seconds": the image loop's
    seconds (the model's build and calibration excluded)}."""
    from PIL import Image

    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import restore_for_eval
    from tpupose_torch.engine.predictor import (BottomUpPredictor,
                                                YoloPosePredictor)

    builder = Builder(cfg, device)
    model = builder.model()
    os.makedirs(output_dir, exist_ok=True)
    if weights:
        model = restore_for_eval(builder, model, weights)  # <dir>[@best]
    else:
        printW("no --ckpt given: running with random weights")
    H, W = cfg.data.image_size
    paths = sorted(p for ext in ("*.jpg", "*.jpeg", "*.png")
                   for p in glob.glob(os.path.join(images_dir, ext)))

    def load(p):
        pil = Image.open(p).convert("RGB")
        return pil, np.asarray(pil.resize((W, H)), np.uint8)

    bottom_up = cfg.model.name == "bottom_up"
    quant_scales = None
    if cfg.eval.int8 and paths:
        calib = (BottomUpPredictor if bottom_up
                 else YoloPosePredictor).calibrate_int8
        quant_scales = calib(model, load(paths[0])[1][None])
        printT(f"int8 serving: calibrated {len(quant_scales)} layers")

    def save(p, img, n, what):
        out_path = os.path.join(output_dir, os.path.basename(p))
        Image.fromarray(img).save(out_path)
        printT(f"{p}: {n} {what} -> {out_path}")

    t0 = time.perf_counter()
    if bottom_up:
        predictor = BottomUpPredictor(
            model, max_people=cfg.data.max_instances,
            score_threshold=cfg.eval.ae_score_threshold,
            tag_threshold=cfg.eval.ae_tag_threshold,
            quant_scales=quant_scales, device=builder.device)
        for p in paths:
            pil, arr = load(p)
            out = predictor(arr[None])
            w0, h0 = pil.size
            kp = np.concatenate([out["coords"][0] * [w0 / W, h0 / H],
                                 out["scores"][0][..., None]], axis=-1)
            img = draw_detections(np.asarray(pil, np.uint8), kp,
                                  out["person_scores"][0],
                                  out["person_mask"][0])
            save(p, img, int(out["person_mask"][0].sum()), "people")
    else:
        predictor = YoloPosePredictor(
            model, num_classes=cfg.model.num_classes,
            num_keypoints=cfg.model.num_keypoints,
            conf_threshold=cfg.eval.conf_threshold,
            iou_threshold=cfg.eval.iou_threshold,
            max_detections=cfg.eval.max_detections,
            has_box_branch=(cfg.model.reg_max > 0
                            or cfg.loss.name == "v8_pose"),
            quant_scales=quant_scales, device=builder.device)
        pool = ThreadPoolExecutor(max_workers=2)
        metas: deque = deque()   # bounded by the pipeline's depth

        def arrays():
            q: deque = deque()
            for p in paths:
                q.append((p, pool.submit(load, p)))
                if len(q) > 2:
                    yield _next_image(q, metas)
            while q:
                yield _next_image(q, metas)

        try:
            for det in predictor.pipeline(arrays()):
                p, pil = metas.popleft()
                w0, h0 = pil.size
                kp = det["keypoints"][0].copy()
                kp[..., 0] *= w0 / W
                kp[..., 1] *= h0 / H
                valid = det["valid"][0]
                img = draw_detections(np.asarray(pil, np.uint8), kp,
                                      det["scores"][0], valid)
                save(p, img, int(valid.sum()), "detections")
        finally:
            pool.shutdown(wait=False)
    seconds = time.perf_counter() - t0
    printS(f"processed {len(paths)} images")
    return {"images": len(paths), "seconds": seconds}


def _next_image(q: deque, metas: deque):
    """The oldest queued load's uint8 batch of one; its (path, PIL image)
    go to `metas` for the drawing."""
    p, fut = q.popleft()
    pil, arr = fut.result()
    metas.append((p, pil))
    return arr[None]


def main(argv=None):
    args = parse_args(argv)
    extra, rest = {}, []
    for item in args.opts:
        k, v = item.split("=", 1)
        if k in ("images_dir", "output_dir"):
            extra[k] = v
        else:
            rest.append(item)
    args.opts = rest
    cfg = update_config(default_config(), args)
    run_inference(cfg, extra.get("images_dir", "images"),
                  extra.get("output_dir", "viz"), args.ckpt,
                  device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
