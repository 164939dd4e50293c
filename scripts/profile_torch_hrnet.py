"""Where the time of an HRNet-W32 256x192 train step, or of an HRNet-W48
384x288 flip predict, goes on the card, through tpupose_torch.

    python3 scripts/profile_torch_hrnet.py --train [--remat] [--batch 64]
    python3 scripts/profile_torch_hrnet.py [--batch 64] [--benchmark]

`--train`: HRNetPose("hrnet_w32") with float32 master weights under bf16
autocast, Adam (hrnet_w32.yaml's lr 1e-3, clip 10) and the heatmap train
step with the device affine warp (K7) and jitter on a batch of the
synthetic set already on the card; `--remat` checkpoints each branch and
stage-1 block. Predict (default): HRNetPose("hrnet_w48") in bf16 with
seeded weights, HeatmapPredictor at 384x288 with flip test (K4 decodes
the 96x72 maps, 11 taps as the predictor's default) on seeded uint8 host
crops. `--benchmark` sets torch.backends.cudnn.benchmark (cuDNN then
times its algorithms for each shape once and keeps the fastest). Then it
runs `--calls` steps or predicts under torch.profiler and prints, per
call: the wall milliseconds (host clock, synchronised), the device busy
milliseconds (union of the kernels' and copies' intervals) and the idle
share, the device milliseconds by group (convolutions by direction,
BatchNorm, the nearest upsample, the optimizer, other elementwise and
reductions, copies, K7, K4), the ten longest kernels and the count of
kernel launches, with the card's name and power limit. Fails where CUDA
is absent or the profiler records no device activity. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_torch_vitpose import union_us  # noqa: E402

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("k7_warp", ("warp_kernel",)),
    ("k4_dark_decode", ("dark_decode",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("copy", ("memcpy", "memset")),
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad",)),
    ("conv_fwd", ("conv", "cudnn", "implicit", "xmma", "cutlass", "nhwc",
                  "sm90", "gemm", "nvjet")),
    ("batch_norm", ("batch_norm", "bn_", "welford")),
    ("upsample", ("upsample",)),
    ("elementwise_reduce", ("elementwise", "reduce", "cat", "index",
                            "copy", "fill", "norm")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def train_call(batch: int, remat: bool):
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_heatmap_train_step)
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.models.backbones.hrnet import HRNetPose

    model = HRNetPose("hrnet_w32", 17, dtype=torch.bfloat16, device="cuda",
                      param_dtype=torch.float32, remat=remat,
                      generator=torch.Generator().manual_seed(21))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-3),
                         model.named_parameters(),
                         is_head=lambda n: not n.startswith("backbone."),
                         grad_clip_norm=10.0)
    state = TrainState(model, opt)
    step = make_heatmap_train_step(
        joints_mse_loss, color_jitter_strength=0.2, heatmap_size=(64, 48),
        affine_rotation=45.0, affine_scale=0.35)
    ds = SyntheticTopDownDataset(batch, (256, 192), (64, 48), 17, seed=0)
    smp = [ds[i] for i in range(batch)]
    db = {k: torch.from_numpy(np.stack([x[src] for x in smp])).cuda()
          for k, src in (("images", "image"), ("joints", "joints"),
                         ("visibility", "visibility"))}
    return lambda: step(state, db)


def predict_call(batch: int):
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.models.backbones.hrnet import HRNetPose

    model = HRNetPose("hrnet_w48", 17, dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator().manual_seed(20))
    pred = HeatmapPredictor(model, (96, 72), flip_test=True)
    crops = np.random.RandomState(0).randint(
        0, 256, (batch, 384, 288, 3)).astype(np.uint8)
    return lambda: pred(crops)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--benchmark", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_hrnet: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.benchmark = args.benchmark
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    call = (train_call(args.batch, args.remat) if args.train
            else predict_call(args.batch))
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        print("profile_torch_hrnet: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 3
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3 / args.calls
    by_group, by_name = defaultdict(float), defaultdict(float)
    for e in dev:
        us = e.time_range.elapsed_us() / args.calls
        by_group[group_of(e.name)] += us / 1e3
        by_name[e.name] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"mode": "train" if args.train else "predict_flip",
           "model": "hrnet_w32 256x192" if args.train
           else "hrnet_w48 384x288", "remat": args.remat,
           "cudnn_benchmark": args.benchmark, "batch": args.batch,
           "calls": args.calls, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
           "img_per_s": args.batch / wall_ms * 1e3,
           "launches_per_call": len(dev) / args.calls,
           "device_ms_by_group": dict(sorted(by_group.items(),
                                             key=lambda kv: -kv[1])),
           "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
