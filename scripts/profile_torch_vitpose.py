"""Where the time of a ViTPose-S 256x192 predict, or train step, goes on
the card, through tpupose_torch.

    python3 scripts/profile_torch_vitpose.py [--batch 128] [--calls 5]
    python3 scripts/profile_torch_vitpose.py --train [--remat] [--batch 128]

Predict (default): builds ViTPose("vit_small", 17, "classic") in bf16
with seeded weights and warms HeatmapPredictor (no flip test) up on
seeded uint8 host crops. `--train`: the same model with float32 master
weights under bf16 autocast, AdamW (vitpose_s.yaml's lr 5e-4, weight
decay 0.1, clip 10) and the heatmap train step (targets rendered in the
step) on a batch of the synthetic set already on the card; `--remat`
checkpoints the blocks. Then it runs `--calls` predicts or steps under
torch.profiler (CPU and CUDA activities) and prints, per call: the wall
milliseconds (host clock, synchronised), the device busy milliseconds
(union of the kernels' and copies' intervals) and the idle share, the
device milliseconds by group (K8 flash attention, K8b its backward,
GEMMs, convolutions and deconvolutions, LayerNorm, the optimizer's
multi-tensor kernels, other elementwise and reductions, copies, K4 DARK
decode), the ten longest kernels, and the card's name and power limit.
Fails where CUDA is absent or the profiler records no device activity.
Imports nothing of JAX.
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

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("k8_flash_attention", ("flash_attention_kernel",)),
    ("k8b_flash_attention_bwd", ("flash_attention_dkv", "flash_attention_dq",
                                 "delta_kernel")),
    ("optimizer", ("multi_tensor", "adam")),
    ("k4_dark_decode", ("dark_decode",)),
    ("copy", ("memcpy", "memset")),
    ("layer_norm", ("layer_norm", "layernorm", "gammabeta")),
    ("conv_deconv", ("conv", "dgrad", "wgrad", "cudnn", "implicit")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "gemv", "splitk")),
    ("elementwise_reduce", ("elementwise", "reduce", "cat", "index",
                            "softmax", "copy", "fill", "gelu", "upsample",
                            "batch_norm", "norm")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def train_call(batch: int, remat: bool):
    """One ViTPose-S train step on a device batch, as a closure."""
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_heatmap_train_step)
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.models.vitpose import ViTPose

    model = ViTPose("vit_small", 17, "classic", dtype=torch.bfloat16,
                    device="cuda", param_dtype=torch.float32, remat=remat,
                    generator=torch.Generator().manual_seed(21))
    opt = make_optimizer(
        OptimizerConfig(name="adamw", lr=5e-4, head_lr=5e-4,
                        weight_decay=0.1), model.named_parameters(),
        is_head=lambda n: not n.startswith("backbone."), grad_clip_norm=10.0)
    state = TrainState(model, opt)
    step = make_heatmap_train_step(joints_mse_loss, heatmap_size=(64, 48))
    ds = SyntheticTopDownDataset(batch, (256, 192), (64, 48), 17, seed=0)
    smp = [ds[i] for i in range(batch)]
    db = {k: torch.from_numpy(np.stack([x[src] for x in smp])).cuda()
          for k, src in (("images", "image"), ("joints", "joints"),
                         ("visibility", "visibility"))}

    def call():
        step(state, db)

    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_vitpose: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.models.vitpose import ViTPose

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    if args.train:
        call = train_call(args.batch, args.remat)
    else:
        model = ViTPose("vit_small", 17, "classic", dtype=torch.bfloat16,
                        device="cuda",
                        generator=torch.Generator().manual_seed(20))
        pred = HeatmapPredictor(model, (64, 48), flip_test=False)
        crops = np.random.RandomState(0).randint(
            0, 256, (args.batch, 256, 192, 3)).astype(np.uint8)

        def call():
            pred(crops)

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
    # kernels and copies; user annotations (the optimizer's record_function
    # range, mirrored on the device timeline) span gaps and are left out
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    left_out = sorted({e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and getattr(e, "is_user_annotation", False)})
    if not dev:
        print("profile_torch_vitpose: the profiler recorded no device "
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
    out = {"mode": "train" if args.train else "predict",
           "remat": args.remat, "batch": args.batch, "calls": args.calls,
           "flip_test": False,
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "img_per_s": args.batch / wall_ms * 1e3,
           "device_ms_by_group": dict(sorted(by_group.items(),
                                             key=lambda kv: -kv[1])),
           "top_kernels_ms": [[n[:90], ms] for n, ms in top],
           "annotations_left_out": left_out}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
