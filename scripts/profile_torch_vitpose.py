"""Where the time of a ViTPose-S 256x192 predict goes on the card, through
tpupose_torch.

    python3 scripts/profile_torch_vitpose.py [--batch 128] [--calls 5]

Builds ViTPose("vit_small", 17, "classic") in bf16 with seeded weights,
warms HeatmapPredictor (no flip test) up on seeded uint8 host crops, then
runs `--calls` predicts under torch.profiler (CPU and CUDA activities)
and prints, per call: the wall milliseconds (host clock, synchronised),
the device busy milliseconds (union of the kernels' and copies'
intervals) and the idle share, the device milliseconds by group (K8
flash attention, GEMMs, convolutions and deconvolutions, LayerNorm,
other elementwise and reductions, copies, K4 DARK decode), the ten
longest kernels, and the card's name and power limit. Fails where CUDA
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

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("k8_flash_attention", ("flash_attention_kernel",)),
    ("k4_dark_decode", ("dark_decode",)),
    ("copy", ("memcpy", "memset")),
    ("layer_norm", ("layer_norm", "layernorm")),
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--calls", type=int, default=5)
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
    model = ViTPose("vit_small", 17, "classic", dtype=torch.bfloat16,
                    device="cuda", generator=torch.Generator().manual_seed(20))
    pred = HeatmapPredictor(model, (64, 48), flip_test=False)
    crops = np.random.RandomState(0).randint(
        0, 256, (args.batch, 256, 192, 3)).astype(np.uint8)
    for _ in range(3):
        pred(crops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            pred(crops)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    out = {"batch": args.batch, "calls": args.calls, "flip_test": False,
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "img_per_s": args.batch / wall_ms * 1e3,
           "device_ms_by_group": dict(sorted(by_group.items(),
                                             key=lambda kv: -kv[1])),
           "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
