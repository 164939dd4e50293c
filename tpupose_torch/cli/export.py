"""Model-export CLI (counterpart of tpupose/cli/export.py): a trained
model's weights and its whole inference program for deployment.

    python -m tpupose_torch.cli.export \
        --cfg tpupose_torch/configs/method/simple_baseline.yaml \
        [--ckpt out/ckpt[@best]] [--device cuda] out=export/model \
        format=both batch=8 [eval.int8=true calib=calib_images.npy]

- `format=npz`: the weights (engine/exporter.export_npz: `params/<name>`
  and `batch_stats/<name>` in the port's state_dict names).
- `format=pt2`: the family's whole inference program traced by
  torch.export and saved as `.pt2` (engine/exporter.export_program):
  normalize -> forward -> flip test -> decode -> back-projection for the
  heatmap and SimCC families (TopDownEvaluator.step: images, centers,
  scales), forward -> AE grouping for the bottom-up family
  (BottomUpPredictor), decode -> NMS for the yolo family
  (YoloPosePredictor._infer; the NMS loop is unrolled into the graph).
  It loads with exporter.load_program and runs without the model's code.
- `format=both`: both files. `format=stablehlo` (JAX's name) raises,
  naming pt2.

The program is traced for `--device` (default cuda; raises where CUDA is
absent) and runs there: on the card the R50 256x192 heatmap program
calls the hand kernels K1-K4 as `tpupose_torch::` ops, a ViT program K8.
`eval.int8` bakes the PTQ intercept (ops/quant.quantized_apply) into the
program, its activation scales calibrated on `calib=<.npy>`, an (N, H,
W, 3) uint8 array of representative inputs (uniform noise without it,
with a warning). Without `--ckpt` the Builder's seeded init is exported,
with a warning.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupose_torch.configs import default_config, parse_args, update_config
from tpupose_torch.utils.logging import printS, printW

FORMATS = ("npz", "pt2", "both")


def family_of(cfg) -> str:
    """The program family of a config's loss, as JAX's export picks it."""
    name = cfg.loss.name
    return ("yolo" if name in ("pose_compute", "v8_pose")
            else "simcc" if name == "simcc_kl"
            else "bottom_up" if name == "ae"
            else "heatmap")


def build_program(cfg, model, batch: int, device, quant_scales=None):
    """(program module, example arguments) of cfg's family for `model` on
    `device`, at batch size `batch`."""
    from tpupose_torch.engine import exporter

    H, W = cfg.data.image_size
    family = family_of(cfg)
    imgs = torch.zeros((batch, H, W, 3), dtype=torch.uint8, device=device)
    if family == "bottom_up":
        from tpupose_torch.engine.predictor import BottomUpPredictor

        pred = BottomUpPredictor(
            model, max_people=cfg.data.max_instances,
            score_threshold=cfg.eval.ae_score_threshold,
            tag_threshold=cfg.eval.ae_tag_threshold,
            quant_scales=quant_scales, device=device)
        return exporter.BottomUpProgram(pred), (imgs,)
    if family == "yolo":
        from tpupose_torch.engine.predictor import YoloPosePredictor

        pred = YoloPosePredictor(
            model, num_classes=cfg.model.num_classes,
            num_keypoints=cfg.model.num_keypoints,
            conf_threshold=cfg.eval.conf_threshold,
            iou_threshold=cfg.eval.iou_threshold,
            max_detections=cfg.eval.max_detections,
            has_box_branch=(cfg.model.reg_max > 0
                            or cfg.loss.name == "v8_pose"),
            quant_scales=quant_scales, device=device)
        return exporter.YoloProgram(pred), (imgs,)
    from tpupose_torch.engine.evaluator import TopDownEvaluator

    ev = TopDownEvaluator(model, tuple(cfg.model.heatmap_size),
                          decode=cfg.eval.decode,
                          flip_test=cfg.eval.flip_test,
                          quant_scales=quant_scales, family=family,
                          device=device)
    centers = torch.tensor([[W / 2, H / 2]] * batch, dtype=torch.float32,
                           device=device)
    scales = torch.tensor([[W, H]] * batch, dtype=torch.float32,
                          device=device)
    return exporter.HeatmapProgram(ev), (imgs, centers, scales)


def export_model(cfg, out: str, fmt: str = "both", batch: int = 8,
                 weights: str = "", calib: str = "", device="cuda"):
    """Write `out`.npz and / or `out`.pt2 for cfg's model; returns the
    paths written."""
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.exporter import export_npz, export_program

    if fmt == "stablehlo":
        raise ValueError("format=stablehlo is the JAX package's program "
                         "format; the port exports format=pt2 "
                         "(torch.export), or format=both")
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; have {FORMATS}")
    builder = Builder(cfg, device)
    model = builder.model()
    if weights:
        from tpupose_torch.engine.checkpoint import restore_for_eval

        model = restore_for_eval(builder, model, weights)
    else:
        printW("no --ckpt given: exporting random weights")
    model.eval()

    quant_scales = None
    if cfg.eval.int8 and fmt in ("pt2", "both"):
        H, W = cfg.data.image_size
        if calib:
            cimgs = np.load(calib)
        else:
            printW("eval.int8 without calib=<images.npy>: calibrating on "
                   "random noise; use real inputs for production export")
            cimgs = np.random.RandomState(0).randint(
                0, 256, (min(batch, 8), H, W, 3)).astype(np.uint8)
        from tpupose_torch.engine.predictor import (HeatmapPredictor,
                                                    YoloPosePredictor)

        cal = (YoloPosePredictor if family_of(cfg) == "yolo"
               else HeatmapPredictor)
        quant_scales = cal.calibrate_int8(model, cimgs)
        printS(f"int8 export: calibrated {len(quant_scales)} layers")

    written = []
    if fmt in ("npz", "both"):
        written.append(export_npz(model, out + ".npz"))
    if fmt in ("pt2", "both"):
        program, example = build_program(cfg, model, batch, builder.device,
                                         quant_scales)
        written.append(export_program(program, example, out + ".pt2"))
    printS("exported: " + ", ".join(written))
    return written


def main(argv=None):
    args = parse_args(argv)
    extra = {"out": "export/model", "format": "both", "batch": "8",
             "calib": ""}
    rest = []
    for item in args.opts:
        k, v = item.split("=", 1)
        if k in extra:
            extra[k] = v
        else:
            rest.append(item)
    args.opts = rest
    cfg = update_config(default_config(), args)
    export_model(cfg, extra["out"], extra["format"], int(extra["batch"]),
                 args.ckpt, calib=extra["calib"], device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
