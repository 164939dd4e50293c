"""Data and checkpoint tools (counterpart of tpupose/cli/tools.py).

    python -m tpupose_torch.cli.tools check-data --images d/images \
        --labels d/labels --out viz/ [--nkpts 4] [--limit 50]
    python -m tpupose_torch.cli.tools check-labels --labels d/labels \
        --nkpts 4 [--delete] [--images d/images]
    python -m tpupose_torch.cli.tools resize --images src/ --out dst/ \
        [--size 640] [--workers 8]
    python -m tpupose_torch.cli.tools convert-coco --ann ann.json \
        --out labels/ [--min-keypoints 1]
    python -m tpupose_torch.cli.tools average-ckpts --cfg <model yaml> \
        --ckpt <run>/ckpt --out <dir> [--last N | --steps S ...] \
        [--device cuda]

`check-data` renders the ground-truth keypoints (cli/test.draw_detections)
and box corners of YOLO-format labels onto their images, as files;
`check-labels` finds label files whose rows have neither 5 + 3K nor
5 + 2K columns, and deletes them (and their images) only with
`--delete` (without it, a dry run); `resize` stretch-resizes a folder of
images to size x size on a thread pool; `convert-coco` writes a COCO
keypoints JSON as YOLO-pose label files (`cls cx cy w h (x y v)*K`,
normalized; data/yolo_pose.YoloPoseDataset reads them). They run on the
host only. `average-ckpts` (SWA): the uniform average of several
periodic checkpoints of one run (engine/checkpoint.average_checkpoints),
saved as a checkpoint directory of its own that loads wherever a
checkpoint does (`model.checkpoint`, `--ckpt`, `restore_for_eval`). The
template state tracks no EMA, so the raw parameters are averaged, as in
JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpupose_torch.data.yolo_pose import IMAGE_EXTS
from tpupose_torch.utils.logging import printS, printT, printW


def _images(folder: str) -> list:
    return sorted(p for e in IMAGE_EXTS
                  for p in glob.glob(os.path.join(folder, e)))


def _label_path(label_dir, img_path):
    stem = os.path.splitext(os.path.basename(img_path))[0]
    return os.path.join(label_dir, stem + ".txt")


def check_data(images: str, labels: str, out: str, nkpts: int = 4,
               limit: int = 50):
    """Render the labelled keypoints (visible where v > 0) and the four
    box corners of each instance onto the first `limit` images, written
    under `out` with their input's names. An image without a label file,
    with an empty one or a malformed one is skipped (with a warning)."""
    from PIL import Image

    from tpupose_torch.cli.test import draw_detections

    os.makedirs(out, exist_ok=True)
    paths = _images(images)[:limit]
    for p in paths:
        with Image.open(p) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
        H, W = img.shape[:2]
        lp = _label_path(labels, p)
        if not os.path.exists(lp):
            printW(f"{p}: no label file")
            continue
        rows = np.loadtxt(lp, ndmin=2, dtype=np.float32)
        if rows.size == 0:
            continue
        if rows.shape[1] < 5 + 3 * nkpts or (rows.shape[1] - 5) % 3 != 0:
            printW(f"{lp}: malformed ({rows.shape[1]} columns), skipping "
                   "(run check-labels)")
            continue
        kpts = rows[:, 5:].reshape(len(rows), -1, 3).copy()
        kpts[..., 0] *= W
        kpts[..., 1] *= H
        kpts[..., 2] = (kpts[..., 2] > 0).astype(np.float32)
        outimg = draw_detections(img, kpts, rows[:, 0],
                                 np.ones(len(rows), bool))
        for r in rows:                       # box corners as dots
            cx, cy, w, h = r[1] * W, r[2] * H, r[3] * W, r[4] * H
            for x, y in ((cx - w / 2, cy - h / 2), (cx + w / 2, cy + h / 2),
                         (cx - w / 2, cy + h / 2), (cx + w / 2, cy - h / 2)):
                xi, yi = int(np.clip(x, 0, W - 1)), int(np.clip(y, 0, H - 1))
                outimg[max(0, yi - 2):yi + 3, max(0, xi - 2):xi + 3] = \
                    (0, 0, 255)
        Image.fromarray(outimg).save(os.path.join(out, os.path.basename(p)))
    printS(f"rendered {len(paths)} images to {out}")


def check_labels(labels: str, nkpts: int, delete: bool = False,
                 images: str = ""):
    """The label files with a row of neither 5 + 3K nor 5 + 2K columns,
    as (path, line, columns) of each file's first such row. With
    `delete` each of them goes, with its image under `images` where
    given; without it nothing is touched (a dry run)."""
    expected = (5 + 3 * nkpts, 5 + 2 * nkpts)
    bad = []
    for lp in sorted(glob.glob(os.path.join(labels, "*.txt"))):
        with open(lp) as f:
            for ln, line in enumerate(f, 1):
                vals = line.split()
                if vals and len(vals) not in expected:
                    bad.append((lp, ln, len(vals)))
                    break
    for lp, ln, n in bad:
        printW(f"{lp}:{ln}: {n} columns (expected {expected})")
        if delete:
            os.remove(lp)
            if images:
                stem = os.path.splitext(os.path.basename(lp))[0]
                for e in (".jpg", ".jpeg", ".png"):
                    ip = os.path.join(images, stem + e)
                    if os.path.exists(ip):
                        os.remove(ip)
            printT(f"deleted {lp}")
    printS(f"{len(bad)} bad label files" + ("" if delete else " (dry run)"))
    return bad


def resize_images(images: str, out: str, size: int = 640, workers: int = 8):
    """Stretch-resize every image of `images` to size x size (PIL's
    default filter) into `out`, on a pool of `workers` threads."""
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    paths = _images(images)

    def work(p):
        with Image.open(p) as im:
            im.convert("RGB").resize((size, size)).save(
                os.path.join(out, os.path.basename(p)))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, paths))
    printS(f"resized {len(paths)} images to {size}x{size} in {out}")


def convert_coco(ann: str, out: str, min_keypoints: int = 1):
    """COCO keypoints JSON -> one `<image stem>.txt` per annotated image,
    rows `cls cx cy w h (x y v)*K` normalized by the image's size, cls =
    category_id - 1, v clamped to {0, 1, 2}. Crowd annotations, those
    without keypoints and those with fewer than `min_keypoints` labelled
    ones are skipped."""
    with open(ann) as f:
        data = json.load(f)
    os.makedirs(out, exist_ok=True)
    images = {im["id"]: im for im in data["images"]}
    rows_per_image: dict = {}
    skipped = 0
    for a in data.get("annotations", []):
        if a.get("iscrowd", 0) or "keypoints" not in a:
            skipped += 1
            continue
        kp = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        if int((kp[:, 2] > 0).sum()) < min_keypoints:
            skipped += 1
            continue
        im = images[a["image_id"]]
        W0, H0 = float(im["width"]), float(im["height"])
        x, y, w, h = [float(v) for v in a["bbox"]]
        cls = int(a.get("category_id", 1)) - 1
        row = [cls, (x + w / 2) / W0, (y + h / 2) / H0, w / W0, h / H0]
        for px, py, pv in kp:
            row += [float(px) / W0, float(py) / H0,
                    float(np.clip(pv, 0, 2))]
        rows_per_image.setdefault(a["image_id"], []).append(row)
    n_rows = 0
    for iid, rows in rows_per_image.items():
        stem = os.path.splitext(images[iid]["file_name"])[0]
        with open(os.path.join(out, os.path.basename(stem) + ".txt"),
                  "w") as f:
            for r in rows:
                f.write(str(int(r[0])) + " "
                        + " ".join(f"{v:.6f}" for v in r[1:]) + "\n")
        n_rows += len(rows)
    printS(f"wrote {len(rows_per_image)} label files / {n_rows} instances "
           f"to {out} ({skipped} annotations skipped)")


def average_ckpts(cfg_path: str, ckpt_dir: str, out_dir: str,
                  last: int = 0, steps=None, device="cuda"):
    """Average the parameters and BatchNorm statistics of periodic
    checkpoints of `ckpt_dir` into a checkpoint under `out_dir`, saved at
    the newest step used."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import (CheckpointManager,
                                                 average_checkpoints)
    from tpupose_torch.engine.train_state import TrainState

    cfg = load_config(cfg_path)
    builder = Builder(cfg, device)
    model = builder.model()
    state = TrainState(model, builder.optimizer(model, 1))
    avg, used = average_checkpoints(ckpt_dir, state, steps=steps, last=last)
    CheckpointManager(out_dir).save(int(avg.step), avg, force=True)
    printS(f"averaged checkpoint ({len(used)} steps) saved to {out_dir}")
    return used


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("check-data")
    a.add_argument("--images", required=True)
    a.add_argument("--labels", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--nkpts", type=int, default=4)
    a.add_argument("--limit", type=int, default=50)
    b = sub.add_parser("check-labels")
    b.add_argument("--labels", required=True)
    b.add_argument("--nkpts", type=int, required=True)
    b.add_argument("--delete", action="store_true")
    b.add_argument("--images", default="")
    c = sub.add_parser("resize")
    c.add_argument("--images", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--size", type=int, default=640)
    c.add_argument("--workers", type=int, default=8)
    d = sub.add_parser("convert-coco")
    d.add_argument("--ann", required=True, help="COCO keypoints json")
    d.add_argument("--out", required=True, help="output labels dir")
    d.add_argument("--min-keypoints", type=int, default=1)
    e = sub.add_parser("average-ckpts")
    e.add_argument("--cfg", required=True, help="model config YAML")
    e.add_argument("--ckpt", required=True, help="checkpoint dir to average")
    e.add_argument("--out", required=True, help="output checkpoint dir")
    e.add_argument("--last", type=int, default=0,
                   help="average the newest N periodic steps (0 = all)")
    e.add_argument("--steps", type=int, nargs="*", default=None,
                   help="explicit step list (overrides --last)")
    e.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.cmd == "check-data":
        check_data(args.images, args.labels, args.out, args.nkpts, args.limit)
    elif args.cmd == "check-labels":
        check_labels(args.labels, args.nkpts, args.delete, args.images)
    elif args.cmd == "convert-coco":
        convert_coco(args.ann, args.out, args.min_keypoints)
    elif args.cmd == "average-ckpts":
        average_ckpts(args.cfg, args.ckpt, args.out, args.last, args.steps,
                      device=args.device)
    else:
        resize_images(args.images, args.out, args.size, args.workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
