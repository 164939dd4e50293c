"""Serving CLI (counterpart of tpupose/cli/serve.py): a top-down heatmap
model over HTTP with dynamic micro-batching (engine/server.py).

    python -m tpupose_torch.cli.serve \
        --cfg tpupose/configs/method/vitpose_s.yaml [--ckpt out/ckpt@best] \
        [--device cuda] serve.port=8080 serve.max_batch=64 serve.window_ms=4

`--device` defaults to cuda (raises where CUDA is absent); `--device cpu`
serves on the CPU. Without `--ckpt` the model keeps its seeded random
init. `eval.flip_test`, `eval.decode` and `eval.int8_engine` apply as in
eval. The int8 engine serves the SimpleBaseline and HRNet families, the
engine chosen by ops/int8_engine.build_int8_engine (SimpleBaseline-R50
on the hand-written int8 kernels, every other one on Int8Engine), as
Trainer.evaluate chooses it.
"""

from __future__ import annotations

import numpy as np

from tpupose_torch.configs import default_config, parse_args, update_config
from tpupose_torch.utils.logging import printS, printT, printW

HEATMAP_FAMILIES = ("simple_baseline", "hrnet", "vitpose")


def build_predictor(cfg, weights: str = "", device="cuda"):
    """cfg -> HeatmapPredictor on `device`, with the weights of the
    checkpoint `weights` (a directory, `<dir>@best` for the best slot;
    the EMA parameters where the run kept them)."""
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.evaluator import COCO_FLIP_PAIRS
    from tpupose_torch.engine.predictor import HeatmapPredictor

    name = cfg.model.name
    if name not in HEATMAP_FAMILIES:
        raise SystemExit(f"serve supports the top-down heatmap families "
                         f"{HEATMAP_FAMILIES}, got model.name={name!r}")
    builder = Builder(cfg, device)
    model = builder.model()
    if weights:
        from tpupose_torch.engine.checkpoint import restore_path
        from tpupose_torch.engine.train_state import TrainState

        state = TrainState(model, builder.optimizer(model, 1),
                           ema_decay=cfg.train.ema_decay)
        state, _ = restore_path(state, weights)
        model = state.for_eval()
    else:
        printW("no --ckpt given: serving random weights")

    H, W = cfg.data.image_size
    int8_engine = None
    if cfg.eval.int8_engine:
        from tpupose_torch.ops.int8_engine import build_int8_engine

        bb = cfg.model.backbone
        if not (bb.startswith("resnet") or bb.startswith("hrnet")):
            raise SystemExit("eval.int8_engine serves the SimpleBaseline/"
                             f"HRNet families only (backbone={bb!r})")
        calib = np.random.randint(0, 256, (8, H, W, 3), np.uint8)
        int8_engine = build_int8_engine(
            model, calib, decode_method=cfg.eval.decode,
            blur_kernel=cfg.eval.blur_kernel, device=device)
        printT("int8 engine built (synthetic calibration; pass real "
               "crops through eval for production scales)")

    pairs = COCO_FLIP_PAIRS if cfg.model.num_keypoints == 17 else None
    return HeatmapPredictor(
        model, cfg.model.heatmap_size, decode=cfg.eval.decode,
        flip_test=cfg.eval.flip_test and pairs is not None,
        flip_pairs=pairs, udp=cfg.data.udp, device=device,
        int8_engine=int8_engine)


def make_server(cfg, weights: str = "", device="cuda"):
    """The PoseServer that `main` runs (not started)."""
    from tpupose_torch.engine.server import PoseServer

    serve = cfg.serve
    return PoseServer(build_predictor(cfg, weights, device),
                      cfg.data.image_size, host=serve.host, port=serve.port,
                      max_batch=serve.max_batch, window_ms=serve.window_ms,
                      model_name=f"{cfg.model.name}/{cfg.model.backbone}")


def main(argv=None):
    args = parse_args(argv)
    cfg = update_config(default_config(), args)
    server = make_server(cfg, args.ckpt, args.device)
    serve = cfg.serve
    printS(f"serving {cfg.model.name}/{cfg.model.backbone} on "
           f"http://{serve.host}:{server.port}  "
           f"(max_batch={serve.max_batch}, window={serve.window_ms}ms, "
           f"buckets={server.batcher.buckets})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        printT("shutting down")
        server.shutdown()


if __name__ == "__main__":
    main()
