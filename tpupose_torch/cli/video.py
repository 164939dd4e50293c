"""Multi-person video pipeline CLI (counterpart of tpupose/cli/video.py):
a folder of frames (natural-sort order) -> DINOv3Pose detection with
appearance embeddings -> optional two-stage top-down refinement ->
appearance + IoU tracking -> annotated frames and `tracks.jsonl`.

    python -m tpupose_torch.cli.video \
        --cfg tpupose_torch/configs/method/dinov3_vitpose.yaml [--ckpt dir[@best]] \
        frames_dir=frames/ output_dir=tracked/ \
        [pose_cfg=tpupose_torch/configs/method/simple_baseline.yaml] \
        [pose_ckpt=dir[@best]] [--device cuda]

Frames are resized to the detector's input size; the stage-2 crops are
cut from that resized frame on the device (K7), and keypoints are scaled
back to each frame's own size for drawing. The frames go through the
detector `eval.video_batch` at a time, the last chunk repeat-padded.
Checkpoints are the port's (engine/checkpoint.py); without one a model
keeps the builder's seeded init. `--device` defaults to cuda and raises
where CUDA is absent; `--device cpu` runs on the CPU. `eval.int8`
serves both stages through the PTQ intercept, the detector calibrated on
the first frame, stage 2 on that frame's person crops. `run_video`
returns the frame count and the seconds of its frame loop (decode,
device work, tracking and drawing; the models' build excluded).
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpupose_torch.configs import default_config, parse_args, update_config
from tpupose_torch.utils.logging import printS, printT


def natural_sort(paths):
    def key(p):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", os.path.basename(p))]

    return sorted(paths, key=key)


def run_video(cfg, frames_dir: str, output_dir: str, weights: str = "",
              pose_cfg: str = "", pose_ckpt: str = "", device="cuda"):
    from PIL import Image

    from tpupose_torch.cli.test import draw_detections
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import restore_for_eval
    from tpupose_torch.engine.predictor import (HeatmapPredictor,
                                                YoloPosePredictor)
    from tpupose_torch.engine.tracker import PoseTracker
    from tpupose_torch.engine.two_stage import (TwoStagePosePredictor,
                                                person_crops)

    os.makedirs(output_dir, exist_ok=True)
    frames = natural_sort(
        p for e in ("*.jpg", "*.jpeg", "*.png")
        for p in glob.glob(os.path.join(frames_dir, e)))
    builder = Builder(cfg, device)
    dev = builder.device
    model = builder.model()
    if weights:
        model = restore_for_eval(builder, model, weights)
    H, W = cfg.data.image_size

    def first_frame():
        return np.array(Image.open(frames[0]).convert("RGB")
                        .resize((W, H)), np.uint8)[None]

    det_scales = None
    if cfg.eval.int8 and frames:
        det_scales = YoloPosePredictor.calibrate_int8(model, first_frame())
        printT(f"int8 serving: detector calibrated ({len(det_scales)} "
               "layers)")
    predictor = YoloPosePredictor(
        model, num_classes=cfg.model.num_classes,
        num_keypoints=cfg.model.num_keypoints,
        conf_threshold=cfg.eval.conf_threshold,
        iou_threshold=cfg.eval.iou_threshold,
        max_detections=cfg.eval.max_detections,
        has_box_branch=(cfg.model.reg_max > 0
                        or cfg.loss.name == "v8_pose"),
        quant_scales=det_scales, appearance=True, device=dev)
    tracker = PoseTracker()

    two_stage = None
    n_kpts = cfg.model.num_keypoints
    if pose_cfg:
        pcfg = load_config(pose_cfg)
        pbuilder = Builder(pcfg, dev)
        pmodel = pbuilder.model()
        if pose_ckpt:
            pmodel = restore_for_eval(pbuilder, pmodel, pose_ckpt)
        pH, pW = pcfg.data.image_size
        max_persons = min(cfg.eval.max_detections, 16)
        pose_scales = None
        if cfg.eval.int8 and frames:
            # calibrate on what stage 2 sees: the detector's person crops
            # of the first frame
            first = torch.as_tensor(first_frame(), device=dev)
            det = predictor.dispatch(first)
            crops, _, _ = person_crops(first, det[0][:, :max_persons],
                                       det[4][:, :max_persons], (pH, pW),
                                       udp=pcfg.data.udp)
            keep = det[4][0, :max_persons]
            calib = crops.to(torch.uint8)
            calib = calib[keep] if bool(keep.any()) else calib[:1]
            pose_scales = HeatmapPredictor.calibrate_int8(pmodel, calib)
            printT(f"int8 serving: stage-2 pose calibrated on "
                   f"{len(calib)} person crops ({len(pose_scales)} layers)")
        two_stage = TwoStagePosePredictor(
            pmodel, crop_size=(pH, pW),
            heatmap_size=tuple(pcfg.model.heatmap_size),
            max_persons=max_persons, decode=pcfg.eval.decode,
            udp=pcfg.data.udp, quant_scales=pose_scales, device=dev)
        n_kpts = pcfg.model.num_keypoints

    # the next chunk's decode and upload overlap the device work on the
    # current one (a one-deep prefetch thread)
    VB = max(1, int(cfg.eval.video_batch))

    def load_chunk(chunk_paths):
        pils = [Image.open(p).convert("RGB") for p in chunk_paths]
        arr = np.stack([np.asarray(p.resize((W, H)), np.uint8)
                        for p in pils])
        if len(pils) < VB:      # one batch shape: repeat-pad the tail
            arr = np.concatenate(
                [arr, np.repeat(arr[-1:], VB - len(pils), axis=0)])
        t = torch.from_numpy(arr)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return pils, t

    chunks = [frames[i:i + VB] for i in range(0, len(frames), VB)]
    pool = ThreadPoolExecutor(max_workers=1)
    pending = pool.submit(load_chunk, chunks[0]) if chunks else None

    # Chunks i+1 and i+2 are queued on the device (their result copies
    # started on a small thread pool) before chunk i's results are
    # consumed; tracking stays causal, the queue drained in order. The
    # two-stage variant chains stage 2 onto the detector's device outputs.
    fetch_pool = ThreadPoolExecutor(max_workers=2)
    inflight: deque = deque()       # (chunk paths, PIL frames, future)
    depth = 2

    log_path = os.path.join(output_dir, "tracks.jsonl")
    fi = 0
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as log:
            def drain_one():
                nonlocal fi
                chunk, pils, fut = inflight.popleft()
                det = fut.result()
                for bi, (p, pil) in enumerate(zip(chunk, pils)):
                    w0, h0 = pil.size
                    v = det["valid"][bi]
                    boxes = det["boxes"][bi][v]
                    kpts = det["keypoints"][bi][v]
                    if "features" in det:
                        feats = det["features"][bi][v]
                    else:
                        feats = (kpts[..., :2].reshape(len(boxes), -1)
                                 / max(H, W) if len(boxes)
                                 else np.zeros((0, 2 * n_kpts)))
                    tracks = tracker.update(boxes, feats, kpts)
                    log.write(json.dumps({
                        "frame": fi, "file": os.path.basename(p),
                        "tracks": [{"id": int(t), "box": b.tolist(),
                                    "keypoints": k.tolist()}
                                   for t, b, k in tracks],
                    }) + "\n")
                    if tracks:
                        tk = np.stack([k for _, _, k in tracks])
                        tk[..., 0] *= w0 / W
                        tk[..., 1] *= h0 / H
                        out = draw_detections(np.asarray(pil, np.uint8), tk,
                                              np.ones(len(tracks)),
                                              np.ones(len(tracks), bool))
                    else:
                        out = np.asarray(pil, np.uint8)
                    Image.fromarray(out).save(
                        os.path.join(output_dir, os.path.basename(p)))
                    printT(f"frame {fi}: {len(tracks)} tracks")
                    fi += 1

            for ci, chunk in enumerate(chunks):
                pils, arr = pending.result()
                pending = (pool.submit(load_chunk, chunks[ci + 1])
                           if ci + 1 < len(chunks) else None)
                out = predictor.dispatch(arr)
                if two_stage is not None:
                    fut = fetch_pool.submit(
                        two_stage.fetch, two_stage.dispatch_from_det(arr, out))
                else:
                    fut = fetch_pool.submit(predictor.fetch, out)
                inflight.append((chunk, pils, fut))
                while len(inflight) > depth:
                    drain_one()
            while inflight:
                drain_one()
    finally:
        pool.shutdown()
        fetch_pool.shutdown()
    seconds = time.perf_counter() - t0
    printS(f"{len(frames)} frames -> {output_dir} (log: {log_path}) in "
           f"{seconds:.2f} s, {len(frames) / max(seconds, 1e-9):.1f} "
           "frames/s")
    return {"frames": len(frames), "seconds": seconds}


def main(argv=None):
    args = parse_args(argv)
    extra, rest = {}, []
    for item in args.opts:
        k, v = item.split("=", 1)
        if k in ("frames_dir", "output_dir", "pose_cfg", "pose_ckpt"):
            extra[k] = v
        else:
            rest.append(item)
    args.opts = rest
    cfg = update_config(default_config(), args)
    run_video(cfg, extra.get("frames_dir", "frames"),
              extra.get("output_dir", "tracked"), args.ckpt,
              pose_cfg=extra.get("pose_cfg", ""),
              pose_ckpt=extra.get("pose_ckpt", ""), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
