"""End-to-end smoke run of tpupose_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and hidden):
  1. the card's name and power limit (nvidia-smi) and torch's device name;
  2. build every hand-written kernel from tpupose_torch/csrc with nvcc
     (into build/tpupose_torch/) and print the build seconds; count the
     wgmma instructions in the SASS of the stem (K1), layer1 (K2), bridge
     (K3), flash-attention (K8), its backward (K8b) (HGMMA, bf16), int8
     bottleneck (K5) and int8 deconv (K6) (IGMMA, s8) libraries by
     cuobjdump, where the toolkit has it, and fail if one has none;
  3. each kernel of the SimpleBaseline-R50 256x192 serving path at B=128
     on seeded inputs: held against its plain PyTorch version at a stated
     tolerance, timed with CUDA events (median of 20 after warm-up) beside
     its plain version and, where one exists, the PyTorch library call
     that computes the same function (timed here as a yardstick only; the
     port never calls it), and its bound on the card (K2's row also
     carries the byte floor of any three-launch layer1);
  3b. the int8 kernels at B=128: CudaServingEngine built from the same
     seeded weights in float32, calibrated on 32 of the crops; K5 (16
     int8 bottlenecks) per stage and K6 (3 deconvs, the last with the
     final conv) per deconv, each on the int8 input the plain chain gives
     it, must EQUAL its plain version (0 differing elements); timed beside
     the plain version, a torch._int_mm yardstick (which must equal the
     plain version too) and the same blocks as bf16 cuDNN convolutions;
  3c. the warp kernel K7 at B=128: seeded (128, 256, 192, 3) uint8 crops
     under seeded matrices (rotation +-60 deg, scale 0.65-1.35, so parts
     of the views fall outside the image) must EQUAL its plain version;
     then crops_from_frames, 32 frames of 480x640 with D=4 person crops
     each -> 128 crops of 256x192, must equal its plain version; for
     each, the count of output tiles whose source footprint did not fit
     shared memory (gathered from device memory) is printed; both
     timed beside the plain version and F.grid_sample (align_corners,
     zero padding) on a float32 NCHW copy made outside the timed region;
  3d. (run after phase 7: with it, or a profiler session, ahead of
     phase 7 the train step measured ~20% slower, and with the port's
     code under the previous script it did not) the flash-attention
     kernel K8 on seeded bf16 q/k/v at the ViTPose-S shape (128, 197, 6,
     64) and the DINOv3 640x640 ViT-B shape (16, 1605, 12, 64): max abs
     error against the plain version (float32 on the same bf16 inputs)
     at most 2e-2 and at most twice that of F.scaled_dot_product_attention
     (a yardstick only; the port never calls it); CUDA-event times of K8,
     the plain version and SDPA;
  4. the slice: SimpleBaseline("resnet50", 17) in bf16 with seeded random
     weights and BatchNorm statistics, HeatmapPredictor with flip test on
     32 uint8 crops; every kernel's launch count is set to 0 before and
     must have risen after; the kernel forward's heatmaps are held against
     the model's plain forward (max rel 0.06, mean rel 5e-3, the bounds of
     tests/test_pallas_stem.py); coordinates must be finite, (32, 17, 2);
  4c. (run after phase 7, as every phase added since) the R50 CLI path:
     cli.serve.build_predictor on the simple_baseline config (flax init,
     float32 weights under bf16 autocast, as `python -m
     tpupose_torch.cli.serve` builds it) answers one flip request, and
     the launch counts of K1 (stem), K2 (layer1), K3 (bridge) and K4
     (decode), set to 0 before, must each have risen; its kernel-route
     heatmaps on 32 crops against the model's own autocast forward (max
     rel 0.06, mean rel 5e-3);
  4b. the int8 slice: HeatmapPredictor(..., int8_engine=engine) with flip
     test on 32 crops, counts of stem_pool, run_chunk, run_deconv and
     dark_decode set to 0 before and risen after; the engine's heatmaps
     against its own plain chain (max rel 0.1, mean rel 5e-3: K1's bf16
     summation order flips a few int8 stem outputs, which propagate) and
     against the float32 model (max rel 0.15, mean rel 0.02, the bounds of
     tests/test_pallas_engine.py); img/s at B=128 of the bf16 kernel
     route, the cuDNN route and the int8 route;
  5. PoseServer on 127.0.0.1 (ephemeral port): 8 concurrent .npy posts,
     17 keypoints each, and /stats must show coalesced batches; 5b. the
     same through a PoseServer over the int8 predictor;
  7. the training slice: Trainer(cfg, device="cuda") with the config of
     tpupose/configs/method/simple_baseline.yaml plus
     data.device_affine=true (SimpleBaseline-R50 256x192, 17 keypoints,
     bf16 autocast over float32 weights, Adam, B=64, synthetic data),
     cut to 3 of its 140 epochs; the warp kernel's count is set to 0
     before and must equal the number of train steps after; every loss
     finite, the last epoch's mean loss below the first's, validate()
     finite, and a fresh Trainer resumes the saved checkpoint to the same
     step with equal parameters. Then one float32 train step (TF32 off,
     fixed draws) of the full R50 at B=4 on the card against the same
     step on the CPU (loss and grad_norm rtol 1e-3); the trainer's img/s
     at B=64, train-step img/s at B=128 with and without the device
     affine augmentation, and the peak device memory;
  8. the ViTPose-S slice: ViTPose("vit_small", 17, "classic") in bf16
     with seeded weights (layer scales and LayerNorm affines at O(1), so
     that attention shows in the heatmaps) and BatchNorm statistics,
     HeatmapPredictor with flip test on 32 crops: K8's count goes from 0
     to exactly 24 (2 forwards x 12 blocks) and K4's rises; the heatmaps
     against the same model with impl="plain" attention (max rel 0.06,
     mean rel 5e-3); finite (32, 17, 2) coordinates; img/s at B=128, flip
     off and on, of the K8 route, the plain-attention route and an SDPA
     route (timed only); 8 posts through a PoseServer; and
     cli.serve.build_predictor on the vitpose_s config (flax init, bf16
     autocast over float32 weights) answering one request through K8;
  3e. (after 3d) the flash-attention backward K8b on seeded bf16 q/k/v
     (strided views of one qkv tensor, as in the model) and do at the
     same two shapes, from K8's o and log-sum-exp: dq, dk, dv each within
     2e-2 of the max |float32 plain gradient| and within 2x the error of
     the autograd backward of F.scaled_dot_product_attention (a yardstick
     only); K8's LSE within 1e-3 of torch.logsumexp of the float32 scores
     (over ln 2); CUDA-event times of K8b, the plain backward and SDPA's
     backward alone (autograd.grad on a retained graph);
  10. (after 8) the ViTPose-S training slice: Trainer(cfg, device="cuda")
     with the config of tpupose/configs/method/vitpose_s.yaml (ViT-S/16,
     classic decoder, 17 keypoints, bf16 autocast over float32 weights,
     AdamW lr 5e-4 wd 0.1, multistep, B=64, synthetic data) cut to 3 of
     its 210 epochs and 1 warmup epoch (of 3: the lr would still be
     ramping from 0); the K8/K8b counts are set to 0 before, and every
     train step must launch exactly 12 of each (K8b 12 x steps in all;
     validate() adds forwards); losses finite and falling, validate()
     finite, a fresh Trainer resumes to the same step with equal
     parameters. Then one bf16-autocast step of the full model at B=16
     from seeded weights (O(1) layer scales) on the K8/K8b route against
     impl="plain" (loss rel 1e-2, every parameter's gradient within 5e-2
     of its max |grad|) and with remat (24 K8 and 12 K8b launches,
     gradients within 1e-5 of those without); train-step img/s at B=128
     on a device batch for the K8/K8b, plain and SDPA (timed only)
     routes and K8/K8b with remat; peak device memory of one B=128 step
     with remat off and on;
  11. (after 10, in a child process) metric evaluation, 11a:
     Trainer(cfg, device="cuda") with the simple_baseline config plus
     eval.run_metrics=true restores the phase-7 checkpoint and runs
     evaluate() (flip, DARK, PCK, MPJPE, COCO OKS-AP) on the builder's
     synthetic valid set, then on 2048 synthetic crops held in host
     memory: the launch counts of K1, K2, K3 and K4, set to 0 before,
     must be exactly 2, 6, 2 and 1 per flip eval batch; every metric
     finite, and on the 2048 crops PCK, mAP, mAP50 and mAP75 within 0.005
     of the same evaluator with the kernel route off (the model's own
     autocast forward); evaluate() img/s of both routes at
     eval.batch_size, flip on; then `cli.train --test` on the same config
     and checkpoint must launch K1-K4. 11b, the COCO-format path: a seeded set of 32 JPEGs of
     480x640 (1-3 persons, 17 keypoints, crowd and unlabelled
     annotations) under build/; the decode path that ran (native or PIL)
     and the train and valid loaders' img/s; one training epoch with
     data.name=coco data.device_affine=true (B=16), in which the warp
     kernel's launches must equal the train steps; evaluate() through
     CocoTopDownDataset with eval.dump_results, whose results JSON must
     hold one entry per kept instance, K1-K4 launching, with its img/s;
  9. device times under torch.profiler, last: K8, its plain version and
     SDPA at both shapes (their `ms`, `plain_ms`, `library_ms`: a K8
     launch is shorter than its wrapper's Python, so CUDA events around
     one call measure the host), the same for K8b (its two launches
     together) against the plain backward and SDPA's backward, K3 and its
     four cuDNN convolutions, K2 and its ten cuDNN convolutions, K7 and
     F.grid_sample (both warps), K1 and conv2d+relu+max_pool2d, K4, K5
     over the 16 blocks and per stage
     beside the same blocks as bf16 cuDNN convolutions, and K6 per deconv
     and over the head beside bf16 cuDNN and the _int_mm chain, beside
     their event times;
  6. a JSON line of every kernel's numbers, then the last line
     {"ok": true, "device": {...}}.

Phases run in the order 1-5, 7, 3d, 3e, 4c, 8, 10, 11, 9, 6. Exits
non-zero without printing a result where CUDA is unavailable. Needs one
card; imports nothing of JAX. Writes only under build/ of the checkout
(the kernels, the native host-IO library, the phase-7 and phase-10
checkpoints and the phase-11 data, removed at the end).
"""

from __future__ import annotations

import copy
import io
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# float32 non-tensor-core FLOP/s, HBM bytes/s, int8 tensor-core OP/s.
PEAKS = {"SXM": (989e12, 67e12, 3.35e12, 1979e12),
         "PCIe": (756e12, 51e12, 2.0e12, 1513e12)}
B = 128
H, W, K = 256, 192, 17
ROOT = Path(__file__).resolve().parent

# tpupose/configs/method/simple_baseline.yaml (the graded SimpleBaseline
# training config, BASELINE.json:8), written out so that the script reads
# no file of the JAX package
SIMPLE_BASELINE = {
    "model": {"name": "simple_baseline", "backbone": "resnet50",
              "num_keypoints": 17, "heatmap_size": [64, 48],
              "freeze_backbone": False},
    "data": {"name": "synthetic", "image_size": [256, 192], "sigma": 2.0},
    "train": {"batch_size": 64, "epochs": 140, "warmup_epochs": 1},
    "loss": {"name": "joints_mse"},
    "optimizer": {"name": "adam", "lr": 1.0e-3},
    "lr_scheduler": {"name": "multistep", "milestones": [90, 120],
                     "gamma": 0.1},
    "eval": {"flip_test": True, "decode": "dark"},
}


# tpupose/configs/method/vitpose_s.yaml (ViTPose-S 256x192: serving in
# phase 8, training in phase 10), written out for the same reason
VITPOSE_S = {
    "model": {"name": "vitpose", "backbone": "vit_small",
              "decoder": "classic", "num_keypoints": 17,
              "heatmap_size": [64, 48], "freeze_backbone": False},
    "data": {"name": "synthetic", "image_size": [256, 192]},
    "train": {"batch_size": 64, "epochs": 210, "warmup_epochs": 3},
    "loss": {"name": "joints_mse", "use_target_weight": True},
    "optimizer": {"name": "adamw", "lr": 5.0e-4, "head_lr": 5.0e-4,
                  "weight_decay": 0.1},
    "lr_scheduler": {"name": "multistep", "milestones": [170, 200]},
    "eval": {"flip_test": True, "decode": "dark"},
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup=3, iters=20):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


PROFILER_SESSIONS = 8


def device_ms(fn, iters=20, label="?"):
    """Device milliseconds per call of fn(): the union of the intervals of
    the kernels and copies that torch.profiler records over `iters` calls
    after warm-up, over `iters`. Unlike cuda_ms it leaves out the time
    the card waits for the host between launches, which dominates a
    kernel shorter than its wrapper's Python. Every timed call launches at
    least one kernel, so a session that recorded fewer device events than
    calls lost some (on the card a session now and then records none, or a
    few, two or three sessions running): it is logged with `label` and
    repeated after a pause, up to PROFILER_SESSIONS sessions in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_SESSIONS):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        iv = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
        if len(iv) >= iters:
            break
        log(f"device_ms({label}): the profiler recorded {len(iv)} device "
            f"events for {iters} calls (session {attempt + 1} of "
            f"{PROFILER_SESSIONS})")
    if len(iv) < iters:
        raise AssertionError(f"device_ms({label}): the profiler recorded "
                             f"{len(iv)} device events for {iters} calls in "
                             f"each of {PROFILER_SESSIONS} sessions")
    total, end = 0.0, -1.0
    for a, b in iv:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3 / iters


# the wgmma kernels and the SASS mnemonic of their products: HGMMA for
# bf16 in, IGMMA for s8 in
WGMMA_SOURCES = {"stem.cu": "HGMMA", "bottleneck.cu": "HGMMA",
                 "bridge.cu": "HGMMA",
                 "flash_attention.cu": "HGMMA",
                 "flash_attention_bwd.cu": "HGMMA",
                 "int8_bottleneck.cu": "IGMMA", "int8_deconv.cu": "IGMMA"}


def hgmma_check(build):
    """Count the wgmma instructions (HGMMA for bf16, IGMMA for int8) in
    the SASS of the libraries built from the wgmma kernels' sources, by
    cuobjdump where the toolkit has it beside nvcc; a library without any
    fails."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        log(f"{tool} not found: wgmma in the SASS not checked")
        return
    counts = {}
    for src, op in WGMMA_SOURCES.items():
        sass = subprocess.run([str(tool), "-sass", str(build._target(src))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts[src] = {op: sass.count(op)}
    log(f"wgmma instructions in the SASS (cuobjdump -sass): "
        f"{json.dumps(counts)}")
    if not all(c for v in counts.values() for c in v.values()):
        raise AssertionError(f"a wgmma kernel has no wgmma: {counts}")


def rel_err(got, want):
    got, want = got.float(), want.float()
    d = (got - want).abs()
    den = want.abs().max().clamp_min(1e-12)
    return d.max().item(), (d.max() / den).item(), (d.mean() / den).item()


def bound_ms(flops, nbytes, flop_rate, byte_rate):
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_macs(p, k, n):
    """P output pixels of a K-deep, N-wide product."""
    return p * k * n


def block_macs(w, pix_out, pix_in):
    """MACs of one folded bottleneck (see cuda_layer1.fold_bottleneck)."""
    m = conv_macs(pix_in, *w["w1"].shape)
    m += conv_macs(pix_out, 9 * w["w2"].shape[2], w["w2"].shape[3])
    m += conv_macs(pix_out, *w["w3"].shape)
    if "wds" in w:
        m += conv_macs(pix_out, *w["wds"].shape)
    return m


def nbytes(*ts):
    total = 0
    for t in ts:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def library_blocks(x, blocks, strides):
    """cuDNN yardstick for the bottleneck kernels: the same folded blocks
    as bf16 F.conv2d calls on channels_last tensors."""
    y = x.permute(0, 3, 1, 2)
    for w, s in zip(blocks, strides):
        h = torch.relu(F.conv2d(y, w["w1c"], w["b1c"]))
        h = torch.relu(F.conv2d(h, w["w2c"], w["b2c"], stride=s, padding=1))
        o = F.conv2d(h, w["w3c"], w["b3c"])
        o = o + (F.conv2d(y, w["wdsc"], stride=s) if "wdsc" in w else y)
        y = torch.relu(o)
    return y


def as_conv_weights(w):
    """Folded [K][N] matmul weights -> OIHW channels_last conv weights."""
    out = {"w1c": w["w1"].t()[:, :, None, None],
           "w2c": w["w2"].permute(3, 2, 0, 1),
           "w3c": w["w3"].t()[:, :, None, None],
           "b1c": w["b1"].to(w["w1"].dtype), "b2c": w["b2"].to(w["w1"].dtype),
           "b3c": w["b3"].to(w["w1"].dtype)}
    if "wds" in w:
        out["wdsc"] = w["wds"].t()[:, :, None, None]
    return {k: v.contiguous(memory_format=torch.channels_last)
            if v.dim() == 4 else v for k, v in out.items()}


def gaussian_maps(n, k, hh, ww, seed):
    """Seeded Gaussian-peaked maps (sigma 2), one zero map per image."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mu = torch.rand((n, k, 2), generator=g, device="cuda")
    mu = mu * torch.tensor([ww - 4.0, hh - 4.0], device="cuda") + 2.0
    ys = torch.arange(hh, device="cuda", dtype=torch.float32)[:, None]
    xs = torch.arange(ww, device="cuda", dtype=torch.float32)[None, :]
    hm = torch.exp(-((xs - mu[..., 0, None, None]) ** 2
                     + (ys - mu[..., 1, None, None]) ** 2) / 8.0)
    hm[:, 0] = 0.0
    return hm.contiguous()


STAGES = ((0, 3), (3, 7), (7, 13), (13, 16))      # int8 blocks per stage


def int_mm(a, w):
    """torch._int_mm (cuBLASLt int8) of a (..., K) int8 by w (N, K) int8
    -> (..., N) float32, the int32 sum rounded once."""
    out = torch._int_mm(a.reshape(-1, a.shape[-1]), w.t())
    return out.float().reshape(*a.shape[:-1], -1)


def rq8(v):
    return torch.clamp(torch.round(torch.clamp_min(v, 0.0)), 0.0, 127.0) \
        .to(torch.int8)


def int_mm_block(x, blk):
    """Yardstick for one int8 bottleneck: _int_mm products, im2col by
    slicing, the plain version's float32 epilogue. Same integers."""
    s = blk.stride
    _, H, W, _ = x.shape
    ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
    h0 = rq8(int_mm(x, blk.w1) * blk.m1 + blk.b1)
    hp = F.pad(h0, (0, 0, 1, 1, 1, 1))
    im = torch.cat([hp[:, dy:dy + s * (ho - 1) + 1:s,
                       dx:dx + s * (wo - 1) + 1:s]
                    for dy in range(3) for dx in range(3)], dim=-1)
    h1 = rq8(int_mm(im, blk.w2) * blk.m2 + blk.b2)
    y = int_mm(h1, blk.w3) * blk.m3 + blk.b3
    if blk.wp is None:
        res = x.float() * blk.r
    else:
        res = int_mm(x[:, ::s, ::s].contiguous(), blk.wp) * blk.mp + blk.bp
    return rq8(y + res)


def int_mm_deconv(x, spec):
    """Yardstick for one int8 deconv: _int_mm per phase over the 2x2
    shifted inputs, the plain version's epilogue, strided interleave."""
    from tpupose_torch.ops.cuda_head import _TAPS

    B, h, w, _ = x.shape
    hp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.empty((B, 2 * h, 2 * w, spec.cout), dtype=torch.int8,
                      device=x.device)
    for p in range(2):
        for q in range(2):
            im = torch.cat([hp[:, 1 + my:1 + my + h, 1 + mx:1 + mx + w]
                            for (my, _) in _TAPS[p] for (mx, _) in _TAPS[q]],
                           dim=-1)
            ph = 2 * p + q
            out[:, p::2, q::2] = rq8(int_mm(im, spec.w[ph]) * spec.mv[ph]
                                     + spec.bv)
    if spec.wf is None:
        return out
    return (int_mm(out, spec.wf) * spec.mf + spec.bf)[..., :spec.kf]


def int8_block_macs(blk, pix_in, pix_out):
    """MACs of one int8 bottleneck, from its packed weights' shapes."""
    m = pix_in * blk.w1.shape[1] * blk.w1.shape[0]
    m += pix_out * blk.w2.shape[1] * blk.w2.shape[0]
    m += pix_out * blk.w3.shape[1] * blk.w3.shape[0]
    if blk.wp is not None:
        m += pix_out * blk.wp.shape[1] * blk.wp.shape[0]
    return m


def serve_check(pred, crops, label):
    """8 concurrent .npy posts through a PoseServer over `pred`: K
    keypoints each, and the batcher must have coalesced them."""
    from tpupose_torch.engine.server import PoseServer

    srv = PoseServer(pred, (H, W), max_batch=8, window_ms=50.0)
    srv.start_background()
    try:
        bodies = []
        for i in range(8):
            buf = io.BytesIO()
            np.save(buf, crops[i])
            bodies.append(buf.getvalue())
        out = [None] * 8

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict", data=bodies[i],
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out[i] = json.loads(r.read())

        ts = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=180)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
    if any(t.is_alive() for t in ts) or any(
            o is None or len(o["keypoints"]) != K for o in out):
        raise AssertionError(f"{label} server answers incomplete: {out}")
    if stats["requests"] != 8 or max(int(k) for k in stats["batch_hist"]) < 2:
        raise AssertionError(f"{label} server did not coalesce: {stats}")
    log(f"server ({label}): 8 answers x {K} keypoints; stats "
        f"{json.dumps(stats)}")


def warp_mats(n, h, w, seed, max_deg=60.0, lo=0.65, hi=1.35):
    """Seeded dst->src matrices on the card: rotation up to +-max_deg and
    scale lo..hi about the centre of an h x w image."""
    g = torch.Generator().manual_seed(seed)
    th = torch.deg2rad((torch.rand(n, generator=g) * 2 - 1) * max_deg)
    mu = lo + (hi - lo) * torch.rand(n, generator=g)
    cos, sin = torch.cos(th) * mu, torch.sin(th) * mu
    A = torch.stack([torch.stack([cos, -sin], -1),
                     torch.stack([sin, cos], -1)], -2)
    c = torch.tensor([w / 2, h / 2])
    return torch.cat([A, (c - A @ c)[..., None]], -1).cuda()


def grid_for(mats, out_hw, src_hw):
    """The F.grid_sample grid (align_corners=True) of dst->src matrices:
    source pixel coordinates normalized to [-1, 1]."""
    Ho, Wo = out_hw
    Hs, Ws = src_hw
    ys = torch.arange(Ho, device="cuda", dtype=torch.float32)[:, None]
    xs = torch.arange(Wo, device="cuda", dtype=torch.float32)[None, :]
    m = mats[:, :, :, None, None]
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return torch.stack([2 * sx / (Ws - 1) - 1, 2 * sy / (Hs - 1) - 1], -1)


def warp_row(label, call, plain, lib, src, n_out, out_hw, f32_peak, hbm):
    """K7 against its plain version (every element equal, else at most
    1e-3 on the 0-255 scale with the count printed) and timed beside the
    plain version and the grid_sample yardstick; `call(gather_count=...)`
    also counts the output tiles whose source footprint did not fit
    shared memory, so that the kernel gathered their taps from device
    memory. Bound: the source read once, the matrices, the float32 output
    written once; ~12 FLOPs of coordinates per pixel and 6 of blend per
    channel."""
    gathered = torch.zeros(1, dtype=torch.int32, device="cuda")
    got, want, lib_out = call(gather_count=gathered), plain(), lib()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    nbad, mae = int((diff > 0).sum()), diff.max().item()
    if not (torch.isfinite(got).all() and mae <= 1e-3):
        raise AssertionError(f"{label}: {nbad} elements differ from the "
                             f"plain version, max {mae}")
    lib_err = (lib_out.permute(0, 2, 3, 1) - want).abs().max().item()
    if lib_err > 0.05:
        raise AssertionError(f"{label}: the grid_sample yardstick differs "
                             f"from the plain version by {lib_err}")
    Ho, Wo = out_hw
    C = src.shape[-1]
    nb = nbytes(src) + n_out * 24 + n_out * Ho * Wo * C * 4
    b_ms, b_by = bound_ms(n_out * Ho * Wo * (12 + 6 * C), nb, f32_peak, hbm)
    row = dict(max_abs_err=mae, differing=nbad, ms=cuda_ms(call),
               plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
               bound_ms=b_ms, bound_by=b_by,
               gathered_tiles=int(gathered.item()))
    log(f"kernel {label}: {nbad} of {got.numel()} elements differ from the "
        f"plain version (max {mae}); {row['gathered_tiles']} tiles gathered "
        f"their taps from device memory; grid_sample vs plain max abs "
        f"{lib_err:.3g}; " + json.dumps({k: v for k, v in row.items()
                                         if k.endswith("ms")
                                         or k == "bound_by"}))
    return row


def attention_row(Bq, L, heads, seed, bf16_peak, hbm):
    """K8 on seeded bf16 (Bq, L, heads, 64) q/k/v against the plain
    version in float32 on the same inputs and the SDPA yardstick. Bound:
    q, k, v read once and o written once; 4 L^2 D products per (batch,
    head) at the bf16 peak. Returns the row, with the CUDA-event times
    (host gaps included) as *events_ms, and the calls whose device times
    (`device_ms`) phase 9 enters as ms, plain_ms and library_ms."""
    from tpupose_torch.ops.attention import attention_reference
    from tpupose_torch.ops.cuda_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((Bq, L, heads, 64), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 0.125

    def sdpa():
        return sdpa_attention(q, k, v, scale)

    got = flash_attention(q, k, v, scale)
    want = attention_reference(q.float(), k.float(), v.float(), scale)
    lib_out = sdpa()
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    lib_err = (lib_out.float() - want).abs().max().item()
    label = f"flash_attention ({Bq}, {L}, {heads}, 64)"
    if not (torch.isfinite(got.float()).all() and err <= 2e-2
            and err <= 2 * lib_err):
        raise AssertionError(f"{label}: max abs err {err} vs the plain "
                             f"version (tol 2e-2 and 2x SDPA's {lib_err})")
    b_ms, b_by = bound_ms(4 * Bq * heads * L * L * 64, 4 * nbytes(q),
                          bf16_peak, hbm)

    def k8():
        return flash_attention(q, k, v, scale)

    def plain():
        return attention_reference(q, k, v, scale)

    row = dict(max_abs_err=err, sdpa_max_abs_err=lib_err, bound_ms=b_ms,
               bound_by=b_by, events_ms=cuda_ms(k8),
               plain_events_ms=cuda_ms(plain), library_events_ms=cuda_ms(sdpa))
    log(f"kernel {label}: max abs err {err:.4g} vs plain (tol 2e-2), SDPA "
        f"{lib_err:.4g}; " + json.dumps({k_: v_ for k_, v_ in row.items()
                                         if k_.endswith("ms")
                                         or k_ == "bound_by"}))
    return row, {"ms": k8, "plain_ms": plain, "library_ms": sdpa}


def attention_bwd_row(Bq, L, heads, seed, bf16_peak, hbm):
    """K8b on seeded bf16 q/k/v (strided views of one (Bq, L, 3*heads*64)
    projection, as RopeAttention cuts them) and do, from K8's o and LSE:
    dq, dk, dv each within 2e-2 of the max |float32 plain gradient| and
    within 2x the error of the autograd backward of
    F.scaled_dot_product_attention on the same inputs (a yardstick only);
    K8's LSE (log2 domain) within 1e-3 of torch.logsumexp of the float32
    scores over ln 2. Bound: q, k, v, o, do read once and dq, dk, dv
    written once; 5 products of 2 L^2 64 FLOPs per (batch, head) at the
    bf16 peak. Returns the row with CUDA-event times (host gaps included)
    and the calls whose device times phase 9 enters as ms (K8b's two
    launches), plain_ms and library_ms (SDPA's backward alone, on a
    retained graph)."""
    from tpupose_torch.ops.attention import attention_backward_reference
    from tpupose_torch.ops.cuda_attention import (_launch,
                                                  flash_attention_backward)

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((Bq, L, 3 * heads * 64), generator=g, device="cuda") \
        .to(torch.bfloat16)
    q, k, v = qkv.view(Bq, L, 3, heads, 64).unbind(2)
    do = torch.randn((Bq, L, heads, 64), generator=g, device="cuda") \
        .to(torch.bfloat16)
    scale = 0.125
    o, lse = _launch(q, k, v, scale, True)
    got = flash_attention_backward(q, k, v, o, lse, do, scale)
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        do.float(), scale)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    do_t = do.transpose(1, 2)
    lib = [t.transpose(1, 2) for t in torch.autograd.grad(
        lib_out, leaves, do_t, retain_graph=True)]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse_err = (lse - torch.logsumexp(scores, dim=-1) / 0.6931471805599453) \
        .abs().max().item()
    del scores
    torch.cuda.synchronize()
    label = f"flash_attention_bwd ({Bq}, {L}, {heads}, 64)"
    errs, lib_errs, abs_err = {}, {}, 0.0
    for name, a, b, w in zip(("dq", "dk", "dv"), got, lib, want):
        den = w.abs().max().item()
        d = (a.float() - w).abs().max().item()
        abs_err = max(abs_err, d)
        errs[name] = d / den
        lib_errs[name] = (b.float() - w).abs().max().item() / den
        if not (torch.isfinite(a.float()).all() and errs[name] <= 2e-2
                and errs[name] <= 2 * lib_errs[name]):
            raise AssertionError(f"{label}: {name} max err {errs[name]:.4g} "
                                 f"of max |ref| (tol 2e-2 and 2x SDPA's "
                                 f"{lib_errs[name]:.4g})")
    if lse_err > 1e-3:
        raise AssertionError(f"{label}: K8's LSE off by {lse_err} (tol 1e-3)")
    b_ms, b_by = bound_ms(10 * Bq * heads * L * L * 64, 8 * nbytes(do),
                          bf16_peak, hbm)

    def k8b():
        return flash_attention_backward(q, k, v, o, lse, do, scale)

    def plain():
        return attention_backward_reference(q, k, v, do, scale)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, leaves, do_t, retain_graph=True)

    row = dict(max_abs_err=abs_err, rel_err=errs, sdpa_rel_err=lib_errs,
               lse_max_abs_err=lse_err, bound_ms=b_ms, bound_by=b_by,
               events_ms=cuda_ms(k8b), plain_events_ms=cuda_ms(plain),
               library_events_ms=cuda_ms(sdpa_bwd))
    log(f"kernel {label}: max err / max |ref| {json.dumps(errs)} (tol 2e-2), "
        f"SDPA backward {json.dumps(lib_errs)}; LSE max abs err "
        f"{lse_err:.3g} (tol 1e-3); " + json.dumps(
            {k_: v_ for k_, v_ in row.items() if k_.endswith("ms")
             or k_ == "bound_by"}))
    return row, {"ms": k8b, "plain_ms": plain, "library_ms": sdpa_bwd}


def set_attention(model, impl):
    """Every RopeAttention of `model` to impl "kernel" or "plain"."""
    from tpupose_torch.models.backbones.vit import RopeAttention

    for m in model.modules():
        if isinstance(m, RopeAttention):
            m.impl = impl


def sdpa_attention(q, k, v, scale=None, impl="kernel"):
    """The SDPA yardstick in fused_attention's place (timing only)."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=scale).transpose(1, 2)


def synthetic_batch(n, seed):
    """n samples of the port's synthetic set at 256x192, 17 keypoints."""
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset

    ds = SyntheticTopDownDataset(n, (H, W), (64, 48), K, seed=seed)
    smp = [ds[i] for i in range(n)]
    return {"images": torch.from_numpy(np.stack([x["image"] for x in smp])),
            "joints": torch.from_numpy(np.stack([x["joints"] for x in smp])),
            "visibility": torch.from_numpy(
                np.stack([x["visibility"] for x in smp]))}


def vit_train_phase(results):
    """Phase 10: ViTPose-S 256x192 training through Trainer on the
    vitpose_s config, then one B=16 step held against plain attention and
    against remat, then train-step img/s of three attention routes and
    peak memory with remat off and on. Fills the K8/K8b rows' training
    launch counts."""
    from tpupose_torch.configs import default_config
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_heatmap_train_step)
    from tpupose_torch.engine.trainer import Trainer
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.models.backbones import vit as vit_mod
    from tpupose_torch.models.vitpose import ViTPose
    from tpupose_torch.ops.attention import fused_attention
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)
    from tpupose_torch.ops.heatmap import gaussian_heatmaps
    from tpupose_torch.ops.preprocess import normalize_images

    out_dir = ROOT / "build" / "chip_smoke_vit_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = default_config()
    cfg.merge_dict(VITPOSE_S)
    cfg.merge_dotted({
        # depth cut: 3 of 210 epochs; warmup 1 epoch instead of 3, or the
        # lr would still be ramping from 0 at the end of the run
        "train.epochs": "3", "train.warmup_epochs": "1",
        "train.output_dir": str(out_dir)})
    cfg.freeze()
    tr = Trainer(cfg, device="cuda")
    step_losses, step_launches = [], []
    step_fn = tr.train_step

    def recording_step(state, batch, draws=None):
        n8, n8b = flash_attention.launches, flash_attention_backward.launches
        m = step_fn(state, batch, draws)
        step_losses.append(m["loss"])
        step_launches.append((flash_attention.launches - n8,
                              flash_attention_backward.launches - n8b))
        return m

    tr.train_step = recording_step
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention_backward.launches = 0
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n_steps = tr.state.step
    n8, n8b = flash_attention.launches, flash_attention_backward.launches
    losses = torch.stack(step_losses).float().cpu()
    spe = tr.steps_per_epoch
    first, last = losses[:spe].mean().item(), losses[-spe:].mean().item()
    log(f"trainer (ViTPose-S 256x192, B=64, bf16 autocast, AdamW): "
        f"{n_steps} steps in {train_s:.1f} s; K8 launches {n8} (in the "
        f"train steps {sum(a for a, _ in step_launches)}, the rest in "
        f"validate), K8b launches {n8b}; losses "
        f"{[round(v, 6) for v in losses.tolist()]}; epoch mean {first:.6f} "
        f"-> {last:.6f}; trainer img/s (last epoch) {tr.img_per_s:.1f}")
    if n_steps != 3 * spe or any(c != (12, 12) for c in step_launches) \
            or n8b != 12 * n_steps:
        raise AssertionError(f"ViTPose train steps {n_steps} (expected "
                             f"{3 * spe}) with K8/K8b launches per step "
                             f"{step_launches} (expected 12 each), K8b "
                             f"{n8b} in all")
    if not (torch.isfinite(losses).all() and last < first):
        raise AssertionError("ViTPose training losses not finite or not "
                             "falling")
    val = tr.validate()
    if not np.isfinite(val):
        raise AssertionError(f"ViTPose validate() not finite: {val}")
    results["flash_attention"].update(launches_train=n8,
                                      launches_per_train_step=12)
    results["flash_attention_bwd"].update(launches=n8b, train_steps=n_steps,
                                          launches_per_train_step=12)
    tr2 = Trainer(cfg, device="cuda")
    if tr2.load_checkpoint() != n_steps or tr2.state.step != n_steps:
        raise AssertionError("ViTPose resume did not restore the step")
    for (k, a_), b_ in zip(tr.model.state_dict().items(),
                           tr2.model.state_dict().values()):
        if not torch.equal(a_, b_):
            raise AssertionError(f"ViTPose resume: {k} differs")
    log(f"ViTPose validate(): {val:.6f}; resume restores step {n_steps} with "
        f"equal parameters and statistics")
    trainer_ips = tr.img_per_s
    del tr, tr2
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # one bf16-autocast step at B=16 from the same weights: K8/K8b vs
    # plain attention, and K8/K8b with remat vs without
    model = ViTPose("vit_small", K, "classic", dtype=torch.bfloat16,
                    device="cuda", param_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(22))
    b16 = {k: v.cuda() for k, v in synthetic_batch(16, seed=11).items()}
    x16 = normalize_images(b16["images"])
    t16, tw16 = gaussian_heatmaps(b16["joints"], b16["visibility"], (64, 48),
                                  2.0)
    t16 = t16.permute(0, 2, 3, 1)
    init = copy.deepcopy(model.state_dict())

    def one_step(impl, remat):
        model.load_state_dict(init)
        set_attention(model, impl)
        model.backbone.remat = remat
        model.zero_grad()
        flash_attention.launches = flash_attention_backward.launches = 0
        loss = joints_mse_loss(model.train()(x16), t16, tw16)
        loss.backward()
        torch.cuda.synchronize()
        counts = (flash_attention.launches, flash_attention_backward.launches)
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}, counts

    lk, gk, ck = one_step("kernel", False)
    lp, gp, cp = one_step("plain", False)
    lr_, gr, cr = one_step("kernel", True)
    set_attention(model, "kernel")
    model.backbone.remat = False

    def worst(ga, gb):
        w = {n: ((ga[n].float() - gb[n].float()).abs().max()
                 / gb[n].float().abs().max().clamp_min(1e-30)).item()
             for n in gb}
        n = max(w, key=w.get)
        return w[n], n

    w_plain, n_plain = worst(gk, gp)
    w_remat, n_remat = worst(gr, gk)
    log(f"ViTPose-S bf16 step at B=16: loss K8/K8b {lk:.7f}, plain "
        f"attention {lp:.7f} (rel {abs(lk / lp - 1):.3g}, tol 1e-2); "
        f"gradients vs plain: worst {w_plain:.4g} of max |grad| ({n_plain}, "
        f"tol 5e-2); launches K8/K8b {ck}, plain {cp}; with remat: loss "
        f"{lr_:.7f} (tol rel 1e-5), launches {cr}, gradients vs without: "
        f"worst "
        f"{w_remat:.3g} ({n_remat}, tol 1e-5)")
    if not (abs(lk / lp - 1) <= 1e-2 and w_plain <= 5e-2
            and ck == (12, 12) and cp == (0, 0)):
        raise AssertionError("ViTPose-S step: the K8/K8b route disagrees "
                             "with plain attention")
    if cr != (24, 12) or w_remat > 1e-5 or abs(lr_ / lk - 1) > 1e-5:
        raise AssertionError("ViTPose-S step with remat: launches or "
                             "gradients differ")
    del gk, gp, gr, init

    # train-step img/s at B=128 on a device batch, three attention routes
    # (K8/K8b, plain, SDPA timed only), and peak memory, remat off and on
    tstate = TrainState(model, make_optimizer(
        OptimizerConfig(name="adamw", lr=5e-4, head_lr=5e-4,
                        weight_decay=0.1), model.named_parameters(),
        is_head=lambda n: not n.startswith("backbone."), grad_clip_norm=10.0))
    fn = make_heatmap_train_step(joints_mse_loss, heatmap_size=(64, 48))
    bb = {k: v.cuda() for k, v in synthetic_batch(B, seed=12).items()}

    def steps_per_s(n=10):
        for _ in range(2):
            fn(tstate, bb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            met = fn(tstate, bb)
        torch.cuda.synchronize()
        if not np.isfinite(met["loss"].item()):
            raise AssertionError("ViTPose B=128 train step loss not finite")
        return B * n / (time.perf_counter() - t0)

    rates, peaks = {}, {}
    for remat in (False, True):
        model.backbone.remat = remat
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn(tstate, bb)
        torch.cuda.synchronize()
        peaks[f"remat_{int(remat)}"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    model.backbone.remat = False
    rates["k8"] = steps_per_s()
    set_attention(model, "plain")
    rates["plain"] = steps_per_s()
    set_attention(model, "kernel")
    vit_mod.fused_attention = sdpa_attention
    try:
        rates["sdpa"] = steps_per_s()
    finally:
        vit_mod.fused_attention = fused_attention
    model.backbone.remat = True
    rates["k8_remat"] = steps_per_s()
    model.backbone.remat = False
    log("ViTPose-S train img/s: trainer at B=64 (its last-epoch figure, host "
        f"data included) {trainer_ips:.1f}; train step at B=128 (device "
        f"batch, bf16 autocast, AdamW; k8 = the port's route, plain = plain "
        f"attention, sdpa = F.scaled_dot_product_attention, timed only) "
        f"{json.dumps(rates)}; peak device memory of one B=128 step (GiB) "
        f"{json.dumps(peaks)}")
    del model, tstate, bb
    torch.cuda.empty_cache()


def write_coco_set(root: Path, n_images: int = 32, seed: int = 0) -> int:
    """A seeded COCO-format keypoint set under `root`: n JPEGs of 480x640
    with 1-3 persons each, 17 keypoints (a blob painted at each labelled
    one), every 8th annotation a crowd and every 8th (offset 5) without a
    labelled keypoint, which the dataset skips. The same files and
    annotations serve train2017 and val2017. Returns the kept instances."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    H0, W0 = 480, 640
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    for split in ("train2017", "val2017"):
        (root / split).mkdir(exist_ok=True)
    g = np.exp(-np.arange(-12, 13, dtype=np.float32) ** 2 / (2 * 6.0 ** 2))
    blob = 200.0 * g[:, None] * g[None, :]
    images, anns = [], []
    for i in range(n_images):
        img = rng.uniform(20, 60, (H0, W0, 3)).astype(np.float32)
        for _ in range(1 + i % 3):
            w, h = rng.uniform(100, 220), rng.uniform(200, 420)
            x, y = rng.uniform(0, W0 - w), rng.uniform(0, H0 - h)
            kp = np.stack([rng.uniform(x, x + w, K), rng.uniform(y, y + h, K),
                           rng.choice([0, 1, 2], K, p=[0.15, 0.25, 0.6])], 1)
            kp[kp[:, 2] == 0, :2] = 0
            a = len(anns)
            if a % 8 == 5:
                kp[:] = 0
            for k in np.flatnonzero(kp[:, 2] > 0):
                cx, cy = int(kp[k, 0]), int(kp[k, 1])
                y0, y1 = max(cy - 12, 0), min(cy + 13, H0)
                x0, x1 = max(cx - 12, 0), min(cx + 13, W0)
                img[y0:y1, x0:x1, k % 3] += blob[y0 - cy + 12:y1 - cy + 12,
                                                 x0 - cx + 12:x1 - cx + 12]
            anns.append({"id": a, "image_id": i, "category_id": 1,
                         "bbox": [x, y, w, h],
                         "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum()),
                         "area": w * h * 0.6, "iscrowd": int(a % 8 == 3)})
        name = f"{i:012d}.jpg"
        pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        for split in ("train2017", "val2017"):
            pil.save(root / split / name, quality=90)
        images.append({"id": i, "file_name": name, "width": W0, "height": H0})
    for split in ("train2017", "val2017"):
        with open(root / "annotations" / f"person_keypoints_{split}.json",
                  "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return sum(1 for a in anns if a["num_keypoints"] > 0 and not a["iscrowd"])


def loader_ips(loader) -> float:
    """img/s of one pass over a loader (host work only)."""
    t0, n = time.perf_counter(), 0
    for b in loader:
        n += len(b["images"])
    return n / (time.perf_counter() - t0)


def _eval_trainer(over: dict):
    """Trainer(device="cuda") on the simple_baseline config + `over`."""
    from tpupose_torch.configs import default_config
    from tpupose_torch.engine.trainer import Trainer

    cfg = default_config()
    cfg.merge_dict(SIMPLE_BASELINE)
    cfg.merge_dotted(over)
    cfg.freeze()
    return Trainer(cfg, device="cuda")


def _r50_wrappers() -> dict:
    from tpupose_torch.ops.cuda_bridge import bridge
    from tpupose_torch.ops.cuda_decode import dark_decode
    from tpupose_torch.ops.cuda_layer1 import layer1
    from tpupose_torch.ops.cuda_stem import stem_pool

    return {"stem_pool": stem_pool, "layer1": layer1, "bridge": bridge,
            "dark_decode": dark_decode}


METRIC_KEYS = ("pck", "mAP", "mAP50", "mAP75")
EVAL_DIR = ROOT / "build" / "chip_smoke_eval"


def _fmt(m):
    return " ".join(f"{k}={m[k]:.6f}" for k in ("mpjpe",) + METRIC_KEYS)


EVAL_CROPS = 2048


def eval_phase(results, ckpt_dir: Path):
    """Phase 11a: metric evaluation of the phase-7 R50 through
    Trainer.evaluate and cli.train --test on the R50 kernel route.

    The route gate is read on EVAL_CROPS synthetic crops, not the
    builder's 64: the phase-7 model sits at the predict-zero plateau
    (the synthetic task paints joints k, k+3, ... in one colour, so 17
    joints cannot be told apart), its heatmaps have no clear peak, and
    the two bf16 routes' rounding moves ~12% of the argmaxes (both ways):
    on 64 crops the net PCK difference then scatters with a spread of
    ~0.004, on 2048 of ~0.0008."""
    from tpupose_torch.cli.train import main as train_main
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset

    wrappers = _r50_wrappers()
    per_batch = {"stem_pool": 2, "layer1": 6, "bridge": 2, "dark_decode": 1}
    keys = METRIC_KEYS
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    over = {"eval.run_metrics": "true", "model.checkpoint": str(ckpt_dir),
            "train.output_dir": str(EVAL_DIR)}
    tr = _eval_trainer(over)

    def routes(label):
        """evaluate() on the kernel route (launches counted) and with the
        route off; returns (kernel metrics, plain metrics, launches)."""
        tr._get_evaluator().fast_r50 = True
        torch.cuda.synchronize()
        for wfn in wrappers.values():
            wfn.launches = 0
        got = tr.evaluate()
        torch.cuda.synchronize()
        counts = {n: wfn.launches for n, wfn in wrappers.items()}
        tr._evaluator.fast_r50 = False
        want = tr.evaluate()
        deltas = {k: abs(got[k] - want[k]) for k in keys}
        log(f"{label}: kernel route {_fmt(got)}; plain route (the model's "
            f"autocast forward) {_fmt(want)}; |kernel - plain| "
            f"{json.dumps(deltas)}; launches {counts}")
        n = len(tr.valid_loader)
        if counts != {k: c * n for k, c in per_batch.items()}:
            raise AssertionError(f"evaluate() launches {counts}, expected "
                                 f"{per_batch} per flip eval batch x {n}")
        if not all(np.isfinite(got[k]) for k in ("mpjpe",) + keys):
            raise AssertionError("kernel-route metrics not finite")
        return deltas, counts

    routes(f"evaluate() of the phase-7 R50 (step {tr.state.step}) on the "
           f"builder's {len(tr.valid_ds)} synthetic valid crops")
    # EVAL_CROPS crops rendered once, held in host memory as the valid
    # loader's batches (the synthetic set renders ~250 img/s on the host)
    tr.valid_ds = SyntheticTopDownDataset(EVAL_CROPS, (H, W), (64, 48), K,
                                          seed=1)
    tr.valid_loader = tr.builder.dataloader(tr.valid_ds, "valid")
    tr.valid_loader = list(tr._eval_batches())
    deltas, counts = routes(f"evaluate() on {EVAL_CROPS} synthetic valid "
                            f"crops")
    if max(deltas.values()) > 0.005:
        raise AssertionError("kernel-route metrics not within 0.005 of the "
                             "plain route's")
    for n, c in counts.items():
        results[n]["launches_evaluate"] = c
    ips = {}
    for label, fast in (("kernel", True), ("plain", False)):
        tr._get_evaluator().fast_r50 = fast
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.evaluate()
            torch.cuda.synchronize()
            runs.append(EVAL_CROPS / (time.perf_counter() - t0))
        ips[label] = runs
    log(f"evaluate() img/s (B={tr.cfg.eval.batch_size}, flip, DARK, PCK + "
        f"MPJPE + OKS-AP, {EVAL_CROPS} crops from host memory, 3 runs): "
        f"kernel route {[round(v, 1) for v in ips['kernel']]}, plain route "
        f"{[round(v, 1) for v in ips['plain']]}")
    results["stem_pool"]["evaluate_img_per_s"] = ips
    del tr
    torch.cuda.empty_cache()

    cfg_path = EVAL_DIR / "simple_baseline.yaml"      # JSON is YAML
    cfg_path.write_text(json.dumps(SIMPLE_BASELINE))
    for wfn in wrappers.values():
        wfn.launches = 0
    rc = train_main(["--cfg", str(cfg_path), "--device", "cuda", "--test"]
                    + [f"{k}={v}" for k, v in over.items()])
    counts = {n: wfn.launches for n, wfn in wrappers.items()}
    log(f"cli.train --test (simple_baseline config, phase-7 checkpoint): "
        f"rc {rc}, launches {counts}")
    if rc != 0 or min(counts.values()) <= 0:
        raise AssertionError("cli.train --test did not evaluate through "
                             "K1, K2, K3 and K4")
    torch.cuda.empty_cache()


def coco_phase(results):
    """Phase 11b: the COCO-format data path, a training epoch on the
    device warp (K7) and evaluate() with its results JSON."""
    from tpupose_torch.data import native_io
    from tpupose_torch.ops.cuda_warp import affine_warp

    wrappers = _r50_wrappers()
    keys = METRIC_KEYS
    coco_root = ROOT / "build" / "chip_smoke_coco"
    shutil.rmtree(coco_root, ignore_errors=True)
    t0 = time.perf_counter()
    n_kept = write_coco_set(coco_root)
    lib = native_io.get_lib()
    why = ("" if lib is not None else
           f" (the native runtime did not build: g++ "
           f"{'present' if shutil.which('g++') else 'absent'}, jpeglib.h "
           f"{'present' if Path('/usr/include/jpeglib.h').exists() else 'absent'})")
    log(f"COCO-format set: 32 JPEGs of 480x640, {n_kept} kept instances, "
        f"written in {time.perf_counter() - t0:.1f} s; decode path: "
        f"{'native' if lib is not None else 'PIL'}{why}")
    res_path = coco_root / "results.json"
    trc = _eval_trainer({"data.name": "coco", "data.root": str(coco_root),
                         "data.device_affine": "true",
                         "eval.run_metrics": "true",
                         "eval.dump_results": str(res_path),
                         "train.epochs": "1", "train.batch_size": "16",
                         "train.output_dir": str(EVAL_DIR / "coco")})
    if len(trc.valid_ds) != n_kept or len(trc.train_ds) != n_kept:
        raise AssertionError(f"CocoTopDownDataset kept {len(trc.valid_ds)} "
                             f"instances, expected {n_kept}")
    ips_train = loader_ips(trc.train_loader)
    ips_valid = loader_ips(trc.valid_loader)
    torch.cuda.synchronize()
    affine_warp.launches = 0
    trc.train()
    torch.cuda.synchronize()
    n_steps, n_warp = trc.state.step, affine_warp.launches
    log(f"COCO training epoch (device affine, B=16): {n_steps} steps, warp "
        f"launches {n_warp}")
    if n_steps != trc.steps_per_epoch or n_warp != n_steps:
        raise AssertionError(f"warp launches {n_warp} != train steps "
                             f"{n_steps} ({trc.steps_per_epoch} expected)")
    results["affine_warp"]["launches_coco_train"] = n_warp
    for wfn in wrappers.values():
        wfn.launches = 0
    t0 = time.perf_counter()
    out = trc.evaluate()
    torch.cuda.synchronize()
    coco_ips = n_kept / (time.perf_counter() - t0)
    counts = {n: wfn.launches for n, wfn in wrappers.items()}
    entries = json.loads(res_path.read_text())
    log(f"COCO evaluate(): {_fmt(out)}; launches {counts}; {len(entries)} "
        f"results-JSON entries")
    if len(entries) != n_kept or min(counts.values()) <= 0 or not all(
            np.isfinite(out[k]) for k in ("mpjpe",) + keys) or not all(
            len(e["keypoints"]) == 3 * K and 0 <= e["image_id"] < 32
            for e in entries):
        raise AssertionError("COCO evaluate(): wrong results JSON, launches "
                             "or metrics")
    log(f"COCO host data img/s ({'native' if lib is not None else 'PIL'} "
        f"decode, {trc.cfg.data.num_workers} loader threads): train loader "
        f"{ips_train:.1f}, valid loader {ips_valid:.1f}; evaluate() end to "
        f"end {coco_ips:.1f}")
    results["affine_warp"]["coco_loader_img_per_s"] = {
        "decode": "native" if lib is not None else "PIL",
        "train": ips_train, "valid": ips_valid, "evaluate": coco_ips}
    del trc
    shutil.rmtree(coco_root, ignore_errors=True)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops import _build
    from tpupose_torch.ops.cuda_bridge import bridge, bridge_reference
    from tpupose_torch.ops.cuda_decode import (dark_decode,
                                               dark_decode_reference)
    from tpupose_torch.ops.cuda_engine import CudaServingEngine
    from tpupose_torch.ops.cuda_head import deconv_reference, run_deconv
    from tpupose_torch.ops.cuda_layer1 import (fold_bottleneck, layer1,
                                               layer1_reference)
    from tpupose_torch.ops.cuda_stages import chunk_reference, run_chunk
    from tpupose_torch.ops.cuda_stem import (center_raw, fold_fast_r50,
                                             stem_pool, stem_pool_reference)
    from tpupose_torch.ops.int8_engine import fold_simple_baseline
    from tpupose_torch.ops.attention import fused_attention
    from tpupose_torch.ops.preprocess import normalize_images

    # plain versions and yardsticks in true float32 / bf16, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 1: the card ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    log(smi.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"torch device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")
    bf16_peak, f32_peak, hbm, i8_peak = PEAKS["PCIe" if "PCIe" in name
                                              else "SXM"]
    log(f"peaks used for bounds: bf16 {bf16_peak:.4g} FLOP/s, f32 "
        f"{f32_peak:.4g} FLOP/s, int8 {i8_peak:.4g} OP/s, HBM {hbm:.4g} B/s")

    # -- phase 2: build ------------------------------------------------------
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{_build.build_seconds:.2f} s")
    hgmma_check(_build)

    # -- phase 3: kernels at B=128 -------------------------------------------
    g = torch.Generator().manual_seed(0)
    model = SimpleBaseline("resnet50", K, dtype=torch.bfloat16,
                           device="cuda", generator=g)
    fw = fold_fast_r50(model)
    gi = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randint(0, 256, (B, H, W, 3), generator=gi, device="cuda",
                         dtype=torch.uint8)
    x0 = normalize_images(imgs)
    x1 = stem_pool_reference(x0, fw["stem"])
    x2 = layer1_reference(x1, fw["layer1"])
    hm = gaussian_maps(B, K, 64, 48, seed=2)
    l1c = [as_conv_weights(w) for w in fw["layer1"]]
    brc = [as_conv_weights(fw["bridge"])]
    stem_c = fw["stem"]["w"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    stem_b = fw["stem"]["bias"].to(torch.bfloat16)

    def lib_stem():
        y = F.conv2d(x0.permute(0, 3, 1, 2), stem_c, stem_b, 2, 3)
        return F.max_pool2d(torch.relu(y), 3, 2, 1)

    p1, p2, p3 = 64 * 48, 64 * 48, 32 * 24
    stem_macs = 128 * 96 * 64 * 147
    specs = [
        # name, route, source, replaces, call, plain, library, args,
        # flops (per batch), bytes (per batch), flop rate, tolerance
        dict(name="stem_pool", source="tpupose_torch/csrc/stem.cu",
             replaces="tpupose/ops/pallas_stem.py:150 _stem_kernel "
                      "(stem_pool_pallas :201, pallas_call :219)",
             call=lambda: stem_pool(x0, fw["stem"]),
             plain=lambda: stem_pool_reference(x0, fw["stem"]),
             library=lib_stem,
             flops=B * (2 * stem_macs + 9 * p1 * 64),
             nbytes=nbytes(x0, fw["stem"]) + B * p1 * 64 * 2,
             rate=bf16_peak, tol=1e-2),
        dict(name="layer1", source="tpupose_torch/csrc/bottleneck.cu",
             replaces="tpupose/ops/pallas_layer1.py:170 _layer1_kernel "
                      "(layer1_pallas :193, pallas_call :216)",
             call=lambda: layer1(x1, fw["layer1"]),
             plain=lambda: layer1_reference(x1, fw["layer1"]),
             library=lambda: library_blocks(x1, l1c, (1, 1, 1)),
             flops=B * 2 * sum(block_macs(w, p2, p2) for w in fw["layer1"]),
             nbytes=nbytes(x1, fw["layer1"]) + B * p2 * 256 * 2,
             rate=bf16_peak, tol=2e-2),
        dict(name="bridge", source="tpupose_torch/csrc/bridge.cu",
             replaces="tpupose/ops/pallas_bridge.py:106 _bridge_kernel "
                      "(bridge_pallas :144, pallas_call :159)",
             call=lambda: bridge(x2, fw["bridge"]),
             plain=lambda: bridge_reference(x2, fw["bridge"]),
             library=lambda: library_blocks(x2, brc, (2,)),
             flops=B * 2 * block_macs(fw["bridge"], p3, p2),
             nbytes=nbytes(x2, {k: v for k, v in fw["bridge"].items()
                                if k != "tmaps"}) + B * p3 * 512 * 2,
             rate=bf16_peak, tol=2e-2),
    ]
    results = {}
    for s in specs:
        got, want = s["call"](), s["plain"]()
        torch.cuda.synchronize()
        mae, mrel, meanrel = rel_err(got, want)
        if not (torch.isfinite(got.float()).all() and mrel <= s["tol"]):
            raise AssertionError(f"{s['name']}: kernel vs plain max rel "
                                 f"{mrel:.3g} > {s['tol']} (max abs {mae})")
        lib_out = s["library"]()
        lib_rel = rel_err(lib_out.permute(0, 2, 3, 1), want)[1]
        b_ms, b_by = bound_ms(s["flops"], s["nbytes"], s["rate"], hbm)
        results[s["name"]] = dict(
            name=s["name"], route="cuda", source=s["source"],
            replaces=s["replaces"], launches=None, max_abs_err=mae,
            ms=cuda_ms(s["call"]), plain_ms=cuda_ms(s["plain"]),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(s["library"]))
        log(f"kernel {s['name']}: max_rel {mrel:.3g} (tol {s['tol']}), "
            f"mean_rel {meanrel:.3g}, library-vs-plain max_rel {lib_rel:.3g}; "
            + json.dumps({k: v for k, v in results[s["name"]].items()
                          if k.endswith("ms")}))

    # K2 in three launches moves each 256-channel intermediate through
    # device memory twice: the floor of any such design, beside its bound
    results["layer1"]["three_launch_bound_ms"] = (
        nbytes(x1, fw["layer1"]) + 5 * B * p2 * 256 * 2) / hbm * 1e3

    # K4: data-dependent work: argmax over every map, the 9-point blur
    # (2 x 121 x 9 FLOPs) and the solve only where the peak is interior
    gc, gs = dark_decode(hm)
    rc, rs = dark_decode_reference(hm)
    torch.cuda.synchronize()
    cerr = (gc - rc).abs().max().item()
    if not (torch.equal(gs, rs) and cerr <= 1e-3):
        raise AssertionError(f"dark_decode: coords max err {cerr} > 1e-3 "
                             f"or scores differ")
    ci = rc.long()
    inner = ((rs > 0) & (ci[..., 0] >= 1) & (ci[..., 0] <= 46)
             & (ci[..., 1] >= 1) & (ci[..., 1] <= 62)).sum().item()
    d_flops = hm.numel() + inner * (2 * 121 * 9 + 9 * 20 + 40)
    b_ms, b_by = bound_ms(d_flops, nbytes(hm) + B * K * 3 * 4, f32_peak, hbm)
    results["dark_decode"] = dict(
        name="dark_decode", route="cuda",
        source="tpupose_torch/csrc/dark_decode.cu",
        replaces="tpupose/ops/pallas_decode.py:40 _decode_kernel "
                 "(dark_decode_pallas :124, pallas_call :145)",
        launches=None, max_abs_err=cerr, ms=cuda_ms(lambda: dark_decode(hm)),
        plain_ms=cuda_ms(lambda: dark_decode_reference(hm)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"kernel dark_decode: coords max err {cerr:.3g} px (tol 1e-3), "
        f"scores equal, {inner} interior peaks; "
        + json.dumps({k: v for k, v in results["dark_decode"].items()
                      if k.endswith("ms")}))
    del x1, x2, hm, l1c, brc

    # -- phase 3b: the int8 kernels at B=128 ---------------------------------
    model32 = SimpleBaseline("resnet50", K, dtype=torch.float32,
                             device="cuda",
                             generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    eng = CudaServingEngine.build(model32, imgs[:32])
    torch.cuda.synchronize()
    log(f"int8 engine build (fold, calibration on 32 crops, packing): "
        f"{time.perf_counter() - t0:.2f} s")
    # K1 as the int8 path calls it: centered raw pixels, scale folded in
    xc = center_raw(imgs).to(torch.bfloat16)
    got, want = stem_pool(xc, eng.stem_w), stem_pool_reference(xc, eng.stem_w)
    torch.cuda.synchronize()
    mae, mrel, _ = rel_err(got, want)
    log(f"kernel stem_pool on the int8 path's input: max_rel {mrel:.3g} "
        f"(tol 1e-2), max abs {mae:.3g}")
    if not (torch.isfinite(got.float()).all() and mrel <= 1e-2):
        raise AssertionError("stem_pool disagrees on the int8 path's input")
    sdiv = torch.full((1,), eng.s_stem, dtype=torch.float32, device="cuda")
    y = torch.clamp(torch.round(want.float() / sdiv), 0, 127).to(torch.int8)
    y_k = torch.clamp(torch.round(got.float() / sdiv), 0, 127).to(torch.int8)
    stem_flips = int((y_k != y).sum())
    log(f"int8 stem output: {stem_flips} of {y.numel()} elements differ "
        f"between K1 and its plain version after quantization")
    results["stem_pool"]["int8_stem_flips"] = stem_flips
    stage_in = []                   # each stage's input from the plain chain
    for lo, hi in STAGES:
        stage_in.append(y)
        for blk in eng.blocks[lo:hi]:
            y = chunk_reference(y, blk)
    head_in = [y]
    for d in eng.deconvs[:-1]:
        head_in.append(deconv_reference(head_in[-1], d))
    del y, y_k, xc, got, want

    # bf16 cuDNN yardsticks of the same functions (phase-3 bf16 model) on
    # bf16 inputs of the same shapes (values: the int8 inputs x 0.05)
    layers = [getattr(model.backbone, f"layer{i + 1}") for i in range(4)]
    stage_convs = [[as_conv_weights(fold_bottleneck(b)) for b in layer]
                   for layer in layers]
    _, fw32, _, _ = fold_simple_baseline(model)
    head_w = [(fw32[f"deconv{i}"][0].to("cuda", torch.bfloat16),
               fw32[f"deconv{i}"][1].to("cuda", torch.bfloat16))
              for i in range(len(eng.deconvs))]
    fin_w = (fw32["final"][0].to("cuda", torch.bfloat16),
             fw32["final"][1].to("cuda", torch.bfloat16))
    stage_bf = [(t.float() * 0.05).to(torch.bfloat16) for t in stage_in]
    head_bf = [(t.float() * 0.05).to(torch.bfloat16) for t in head_in]

    def cudnn_stages(i0, i1):
        x = stage_bf[i0]
        for i in range(i0, i1):
            strides = [2 if i > 0 and j == 0 else 1
                       for j in range(len(stage_convs[i]))]
            x = library_blocks(x, stage_convs[i], strides).permute(0, 2, 3, 1)
        return x

    def cudnn_head(i0, i1):
        x = head_bf[i0].permute(0, 3, 1, 2)
        for i in range(i0, i1):
            x = torch.relu(F.conv_transpose2d(x, *head_w[i], stride=2,
                                              padding=1))
            if i == len(deconvs8) - 1:
                x = F.conv2d(x, *fin_w)
        return x

    def chain(fn, x, items):
        for it in items:
            x = fn(x, it)
        return x

    def tensors(obj):
        return [v for v in vars(obj).values() if isinstance(v, torch.Tensor)]

    def stage_cost(x, blks):
        Bx, h, w, _ = x.shape
        macs = 0
        for b in blks:
            ho, wo = (h - 1) // b.stride + 1, (w - 1) // b.stride + 1
            macs += int8_block_macs(b, h * w, ho * wo)
            h, w = ho, wo
        nb = nbytes(x, [tensors(b) for b in blks]) + Bx * h * w * blks[-1].cout
        return 2 * Bx * macs, nb

    def head_cost(x, specs_):
        Bx, h, w, _ = x.shape
        macs, nb = 0, nbytes(x, [tensors(d) for d in specs_])
        for d in specs_:
            macs += 16 * h * w * d.cin * d.cout
            if d.wf is not None:
                macs += 4 * h * w * d.cout * d.kf
            h, w = 2 * h, 2 * w
        last = specs_[-1]
        nb += Bx * h * w * (4 * last.kf if last.wf is not None else last.cout)
        return 2 * Bx * macs, nb

    def measure(label, call, plain, lib, bf16, ops, nb):
        got, want, lib_out = call(), plain(), lib()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        nbad = int((diff > 0).sum())
        if not torch.isfinite(got.float()).all() or nbad:
            raise AssertionError(f"{label}: {nbad} elements differ from the "
                                 f"plain version (max {diff.max().item()})")
        if not torch.equal(lib_out, want):
            raise AssertionError(f"{label}: the _int_mm yardstick differs "
                                 f"from the plain version")
        b_ms, b_by = bound_ms(ops, nb, i8_peak, hbm)
        row = dict(name=label, max_abs_err=diff.max().item(),
                   ms=cuda_ms(call), plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(lib), bf16_cudnn_ms=cuda_ms(bf16),
                   bound_ms=b_ms, bound_by=b_by)
        log(f"kernel {label}: equal to plain (0 of {got.numel()} differ), "
            f"_int_mm equal; " + json.dumps(
                {k: v for k, v in row.items() if k.endswith("ms")
                 or k == "bound_by"}))
        k5_device.append((row, call, bf16, lib))
        return row

    # (row, kernel call, cuDNN call, _int_mm call) of K5 and K6: phase 9
    k5_device = []

    k5_parts = []
    blocks8 = list(eng.blocks)      # kept for phase 9 after eng is freed
    deconvs8 = list(eng.deconvs)
    for i, (lo, hi) in enumerate(STAGES):
        x, blks = stage_in[i], blocks8[lo:hi]
        k5_parts.append(measure(
            f"run_chunk layer{i + 1} ({hi - lo} blocks)",
            lambda x=x, b=blks: chain(run_chunk, x, b),
            lambda x=x, b=blks: chain(chunk_reference, x, b),
            lambda x=x, b=blks: chain(int_mm_block, x, b),
            lambda i=i: cudnn_stages(i, i + 1), *stage_cost(x, blks)))
    k5 = measure("run_chunk all 16 blocks",
                 lambda: chain(run_chunk, stage_in[0], blocks8),
                 lambda: chain(chunk_reference, stage_in[0], blocks8),
                 lambda: chain(int_mm_block, stage_in[0], blocks8),
                 lambda: cudnn_stages(0, 4),
                 *stage_cost(stage_in[0], blocks8))
    k6_parts = []
    for i, d in enumerate(deconvs8):
        x = head_in[i]
        k6_parts.append(measure(
            f"run_deconv deconv{i}" + (" + final" if d.wf is not None
                                       else ""),
            lambda x=x, d=d: run_deconv(x, d),
            lambda x=x, d=d: deconv_reference(x, d),
            lambda x=x, d=d: int_mm_deconv(x, d),
            lambda i=i: cudnn_head(i, i + 1), *head_cost(x, [d])))
    x = head_in[0]
    k6 = measure("run_deconv all 3",
                 lambda x=x: chain(run_deconv, x, deconvs8),
                 lambda x=x: chain(deconv_reference, x, deconvs8),
                 lambda x=x: chain(int_mm_deconv, x, deconvs8),
                 lambda: cudnn_head(0, len(deconvs8)),
                 *head_cost(x, deconvs8))
    results["run_chunk"] = dict(
        name="run_chunk", route="cuda",
        source="tpupose_torch/csrc/int8_bottleneck.cu",
        replaces="tpupose/ops/pallas_stages.py:311 _chunk_kernel "
                 "(run_chunk :376, pallas_call :398)",
        launches=None, **{k: v for k, v in k5.items() if k != "name"},
        parts=k5_parts)
    results["run_deconv"] = dict(
        name="run_deconv", route="cuda",
        source="tpupose_torch/csrc/int8_deconv.cu",
        replaces="tpupose/ops/pallas_head.py:122 _deconv_kernel "
                 "(run_deconv :177, pallas_call :198)",
        launches=None, **{k: v for k, v in k6.items() if k != "name"},
        parts=k6_parts)
    del head_in                     # head_bf stays: phase 9 times cuDNN on it
    # K5's and K6's rows (per stage or deconv, then all as results[...])
    k6_device = [(results["run_deconv"] if row is k6 else row, call, bf16,
                  lib) for row, call, bf16, lib in k5_device
                 if row["name"].startswith("run_deconv")]
    k5_device = [(results["run_chunk"] if row is k5 else row, call, bf16)
                 for row, call, bf16, _ in k5_device
                 if row["name"].startswith("run_chunk")]

    # -- phase 3c: the warp kernel (K7) at B=128 -----------------------------
    from tpupose_torch.ops.affine import batched_affine_warp, get_affine_matrix
    from tpupose_torch.ops.cuda_warp import (_plain_crops, affine_warp,
                                             crops_from_frames)

    wm = warp_mats(B, H, W, seed=3)
    src_f = imgs.permute(0, 3, 1, 2).float().contiguous()
    grid = grid_for(wm, (H, W), (H, W))
    k7 = warp_row("affine_warp",
                  lambda **kw: affine_warp(imgs, wm, (H, W), **kw),
                  lambda: batched_affine_warp(imgs, wm, (H, W)),
                  lambda: F.grid_sample(src_f, grid, mode="bilinear",
                                        padding_mode="zeros",
                                        align_corners=True),
                  imgs, B, (H, W), f32_peak, hbm)
    nf, D, FH, FW = 32, 4, 480, 640
    gf = torch.Generator(device="cuda").manual_seed(4)
    frames = torch.randint(0, 256, (nf, FH, FW, 3), generator=gf,
                           device="cuda", dtype=torch.uint8)
    gb = torch.Generator().manual_seed(5)
    hgt = 150 + 300 * torch.rand(nf * D, generator=gb)     # person boxes
    centers = torch.stack([80 + 480 * torch.rand(nf * D, generator=gb),
                           80 + 320 * torch.rand(nf * D, generator=gb)], -1)
    cm = get_affine_matrix(centers, torch.stack([hgt * W / H, hgt], -1),
                           0.0, (H, W)).cuda()
    rep_f = frames.permute(0, 3, 1, 2).float().repeat_interleave(D, 0) \
        .contiguous()
    cgrid = grid_for(cm, (H, W), (FH, FW))
    k7c = warp_row(f"crops_from_frames ({nf} frames {FH}x{FW}, D={D})",
                   lambda **kw: crops_from_frames(frames, cm, (H, W), **kw),
                   lambda: _plain_crops(frames, cm, (H, W)),
                   lambda: F.grid_sample(rep_f, cgrid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True),
                   frames, nf * D, (H, W), f32_peak, hbm)
    results["affine_warp"] = dict(
        name="affine_warp", route="cuda", source="tpupose_torch/csrc/warp.cu",
        replaces="tpupose/ops/pallas_warp.py:38 _warp_kernel "
                 "(pallas_affine_warp :80, pallas_call :93; "
                 "pallas_crops_from_frames :113, pallas_call :134)",
        launches=None, **k7, crops_from_frames=k7c)
    del src_f, grid, frames, rep_f, cgrid

    # -- phase 4: the slice ----------------------------------------------------
    wrappers = {"stem_pool": stem_pool, "layer1": layer1, "bridge": bridge,
                "dark_decode": dark_decode}
    pred = HeatmapPredictor(model, (64, 48), flip_test=True)
    crops = imgs[:32].cpu().numpy()
    torch.cuda.synchronize()
    for wfn in wrappers.values():
        wfn.launches = 0
    coords, scores = pred(crops)
    counts = {n: wfn.launches for n, wfn in wrappers.items()}
    log(f"slice launches (B=32, flip): {counts}")
    for n, c in counts.items():
        if c <= 0:
            raise AssertionError(f"main path never launched {n}")
        results[n]["launches"] = c
    if coords.shape != (32, K, 2) or not np.isfinite(coords).all() \
            or not np.isfinite(scores).all():
        raise AssertionError(f"bad coords {coords.shape}")
    xs = x0[:32]
    hm_k = pred.evaluator.forward(xs).float()
    with torch.no_grad():
        hm_p = model(xs).float()
    _, mrel, meanrel = rel_err(hm_k, hm_p)
    log(f"slice heatmaps kernel path vs plain forward: max_rel {mrel:.4g} "
        f"(<0.06), mean_rel {meanrel:.4g} (<5e-3), shape "
        f"{tuple(hm_k.shape)}")
    if not (torch.isfinite(hm_k).all() and mrel < 0.06 and meanrel < 5e-3):
        raise AssertionError("slice heatmaps disagree with the plain forward")

    # -- phase 4b: the int8 slice ---------------------------------------------
    wrappers8 = {"stem_pool": stem_pool, "run_chunk": run_chunk,
                 "run_deconv": run_deconv, "dark_decode": dark_decode}
    pred8 = HeatmapPredictor(model32, (64, 48), flip_test=True,
                             int8_engine=eng)
    torch.cuda.synchronize()
    for wfn in wrappers8.values():
        wfn.launches = 0
    coords, scores = pred8(crops)
    counts = {n: wfn.launches for n, wfn in wrappers8.items()}
    log(f"int8 slice launches (B=32, flip): {counts}")
    for n, c in counts.items():
        if c <= 0:
            raise AssertionError(f"int8 path never launched {n}")
        results[n]["launches" if n.startswith("run_") else "launches_int8"] = c
    if coords.shape != (32, K, 2) or not np.isfinite(coords).all() \
            or not np.isfinite(scores).all():
        raise AssertionError(f"bad int8 coords {coords.shape}")
    c32 = imgs[:32]
    hm8 = eng.forward(c32)
    hm8_plain = eng.forward_reference(c32)
    with torch.no_grad():
        hm32 = model32(normalize_images(c32, dtype=torch.float32)).float()
    _, mrel_p, meanrel_p = rel_err(hm8, hm8_plain)
    _, mrel, meanrel = rel_err(hm8, hm32)
    # Everything after K1 is bit-equal to its plain version (phase 3b), but
    # K1's bf16 sums differ from the plain stem's by one bf16 ulp here and
    # there, which flips some int8 stem outputs (counted in phase 3b); the
    # flips propagate through the 16 blocks, hence 0.1 / 5e-3, not 1e-3.
    log(f"int8 heatmaps vs the engine's plain chain: max_rel {mrel_p:.4g} "
        f"(<=0.1), mean_rel {meanrel_p:.4g} (<=5e-3); vs the float32 model: "
        f"max_rel {mrel:.4g} (<0.15), mean_rel {meanrel:.4g} (<0.02), shape "
        f"{tuple(hm8.shape)}")
    if not (torch.isfinite(hm8).all() and mrel_p <= 0.1
            and meanrel_p <= 5e-3 and mrel < 0.15 and meanrel < 0.02):
        raise AssertionError("int8 heatmaps out of bounds")

    def img_per_s(p):
        p(big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 10
        for _ in range(n):
            p(big)
        return B * n / (time.perf_counter() - t0)

    rates = {}
    big = imgs.cpu().numpy()
    for flip in (False, True):
        p = HeatmapPredictor(model, (64, 48), flip_test=flip)
        rates[f"kernels_flip{int(flip)}"] = img_per_s(p)
        p.evaluator.fast_weights = None           # cuDNN forward, same model
        rates[f"plain_flip{int(flip)}"] = img_per_s(p)
        rates[f"int8_flip{int(flip)}"] = img_per_s(HeatmapPredictor(
            model32, (64, 48), flip_test=flip, int8_engine=eng))
    log("slice img/s at B=128 (uint8 host crops -> source coords on host; "
        "kernels = bf16 kernel route, plain = bf16 cuDNN route, int8 = "
        "int8 engine): " + json.dumps(rates))

    # -- phase 5: the servers --------------------------------------------------
    serve_check(pred, crops, "bf16 kernels")
    serve_check(pred8, crops, "int8")

    # -- phase 7: the training slice -------------------------------------------
    from tpupose_torch.configs import default_config
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_heatmap_train_step)
    from tpupose_torch.engine.trainer import Trainer
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.models.simple_baseline import init_like_flax

    del eng, model, model32, pred, pred8
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = default_config()
    cfg.merge_dict(SIMPLE_BASELINE)
    cfg.merge_dotted({"data.device_affine": "true",
                      # depth cut: 3 of 140 epochs (the multistep schedule's
                      # first epochs do not depend on the total)
                      "train.epochs": "3",
                      "train.output_dir": str(out_dir)})
    cfg.freeze()
    tr = Trainer(cfg, device="cuda")
    step_losses = []
    step_fn = tr.train_step

    def recording_step(state, batch, draws=None):
        m = step_fn(state, batch, draws)
        step_losses.append(m["loss"])
        return m

    tr.train_step = recording_step
    torch.cuda.synchronize()
    affine_warp.launches = 0
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n_steps, n_warp = tr.state.step, affine_warp.launches
    losses = torch.stack(step_losses).float().cpu()
    spe = tr.steps_per_epoch
    first, last = losses[:spe].mean().item(), losses[-spe:].mean().item()
    log(f"trainer (R50 256x192, B=64, bf16 autocast, Adam, device affine): "
        f"{n_steps} steps in {train_s:.1f} s, warp launches {n_warp}; "
        f"losses {[round(v, 6) for v in losses.tolist()]}; epoch mean "
        f"{first:.6f} -> {last:.6f}; trainer img/s (last epoch) "
        f"{tr.img_per_s:.1f}")
    if n_warp != n_steps or n_steps != 3 * spe:
        raise AssertionError(f"warp launches {n_warp} != train steps "
                             f"{n_steps} (expected {3 * spe})")
    if not (torch.isfinite(losses).all() and last < first):
        raise AssertionError("training losses not finite or not falling")
    val = tr.validate()
    if not np.isfinite(val):
        raise AssertionError(f"validate() not finite: {val}")
    results["affine_warp"].update(launches=n_warp, train_steps=n_steps,
                                  launches_per_train_step=n_warp / n_steps)
    tr2 = Trainer(cfg, device="cuda")
    if tr2.load_checkpoint() != n_steps or tr2.state.step != n_steps:
        raise AssertionError("resume did not restore the step")
    for (k, a_), b_ in zip(tr.model.state_dict().items(),
                           tr2.model.state_dict().values()):
        if not torch.equal(a_, b_):
            raise AssertionError(f"resume: {k} differs")
    log(f"validate(): {val:.6f}; resume restores step {n_steps} with equal "
        f"parameters and statistics")
    trainer_ips = tr.img_per_s
    del tr, tr2                     # out_dir's checkpoint serves phase 11
    torch.cuda.empty_cache()

    # one float32 step (TF32 off) of the full R50 at B=4: card vs CPU
    aug = dict(color_jitter_strength=0.2, jitter_seed=0, heatmap_size=(64, 48),
               sigma=2.0, affine_rotation=30.0, affine_scale=0.25)
    step32 = make_heatmap_train_step(joints_mse_loss, **aug)
    m_cpu = SimpleBaseline("resnet50", K, dtype=torch.float32, device="cpu",
                           param_dtype=torch.float32)
    init_like_flax(m_cpu, torch.Generator().manual_seed(7))
    m_gpu = copy.deepcopy(m_cpu).cuda()
    b4 = synthetic_batch(4, seed=8)
    draws = step32.draws_for(0, 4, "cpu")
    one = {}
    for dev, m in (("cpu", m_cpu), ("cuda", m_gpu)):
        opt = make_optimizer(OptimizerConfig(name="sgd", lr=0.01),
                             m.named_parameters(), grad_clip_norm=10.0)
        mv = lambda t: t.to(dev)  # noqa: E731
        d = {k: tuple(mv(t) for t in v) for k, v in draws.items()}
        met = step32(TrainState(m, opt), {k: mv(v) for k, v in b4.items()},
                     draws=d)
        one[dev] = (met["loss"].item(), met["grad_norm"].item())
    (lc, gc), (lg, gg) = one["cpu"], one["cuda"]
    log(f"float32 R50 train step, B=4: loss card {lg:.7f} cpu {lc:.7f}, "
        f"grad_norm card {gg:.6f} cpu {gc:.6f}")
    if not (abs(lg / lc - 1) <= 1e-3 and abs(gg / gc - 1) <= 1e-3):
        raise AssertionError("the card's float32 step differs from the CPU's")
    del m_cpu, m_gpu

    # train-step img/s at B=128, with and without the device affine warp
    tm = SimpleBaseline("resnet50", K, dtype=torch.bfloat16, device="cpu",
                        param_dtype=torch.float32)
    init_like_flax(tm, torch.Generator().manual_seed(9))
    tm = tm.cuda()
    tstate = TrainState(tm, make_optimizer(
        OptimizerConfig(name="adam", lr=1e-3), tm.named_parameters(),
        is_head=lambda n: not n.startswith("backbone"), grad_clip_norm=10.0))
    bb = {k: v.cuda() for k, v in synthetic_batch(B, seed=10).items()}
    rates = {}
    torch.cuda.reset_peak_memory_stats()
    for affine in (True, False):
        kw = dict(aug, affine_rotation=30.0 if affine else 0.0,
                  affine_scale=0.25 if affine else 0.0)
        fn = make_heatmap_train_step(joints_mse_loss, **kw)
        for _ in range(2):
            fn(tstate, bb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            met = fn(tstate, bb)
        torch.cuda.synchronize()
        rates[f"device_affine_{int(affine)}"] = \
            B * 10 / (time.perf_counter() - t0)
        if not np.isfinite(met["loss"].item()):
            raise AssertionError("B=128 train step loss not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train img/s: trainer at B=64 (its last-epoch figure, host data "
        f"included) {trainer_ips:.1f}; train step at B=128 (device batch, "
        f"bf16 autocast, Adam) {json.dumps(rates)}; peak device memory "
        f"at B=128 {peak:.2f} GiB")

    del tm, tstate, bb
    torch.cuda.empty_cache()
    # -- phase 3d: the flash-attention kernel (K8), run after phase 7 --------
    k8, k8_calls = attention_row(B, 197, 6, 6, bf16_peak, hbm)
    k8_dino, dino_calls = attention_row(16, 1605, 12, 7, bf16_peak, hbm)
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="tpupose_torch/csrc/flash_attention.cu",
        replaces="tpupose/ops/attention.py:45 _flash (library Pallas "
                 "flash_attention, call :69; dispatch fused_attention :84)",
        launches=None, **k8, dinov3_640_vit_b=k8_dino)
    torch.cuda.empty_cache()

    # -- phase 3e: the flash-attention backward (K8b), beside 3d ------------
    k8b, k8b_calls = attention_bwd_row(B, 197, 6, 8, bf16_peak, hbm)
    k8b_dino, k8b_dino_calls = attention_bwd_row(16, 1605, 12, 9, bf16_peak,
                                                 hbm)
    results["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="tpupose_torch/csrc/flash_attention_bwd.cu",
        replaces="tpupose/ops/attention.py:45 _flash -> library Pallas "
                 "flash_attention custom VJP (jax/experimental/pallas/ops/"
                 "tpu/flash_attention.py: _flash_attention_bwd :254, di :273, "
                 "_flash_attention_dkv_kernel :796 pallas_call :1121, "
                 "_flash_attention_dq_kernel :1146 pallas_call :1456; block "
                 "sizes tpupose/ops/attention.py:53-56)",
        launches=None, **k8b, dinov3_640_vit_b=k8b_dino)
    torch.cuda.empty_cache()

    # -- phase 4c (run after phase 7, as every new phase): cli.serve's R50 --
    from tpupose_torch.cli.serve import build_predictor

    cfg = default_config()
    cfg.merge_dict(SIMPLE_BASELINE)
    cfg.freeze()
    cli_r50 = build_predictor(cfg, "", device="cuda")
    for wfn in wrappers.values():
        wfn.launches = 0
    c1, s1 = cli_r50(crops[:1])
    counts = {n: wfn.launches for n, wfn in wrappers.items()}
    log(f"cli.serve.build_predictor (simple_baseline config, flax init, "
        f"float32 weights under bf16 autocast): one flip request, launches "
        f"{counts}, coords {c1.shape}")
    if c1.shape != (1, K, 2) or not np.isfinite(c1).all() \
            or not np.isfinite(s1).all() or min(counts.values()) <= 0:
        raise AssertionError("cli.serve's R50 predictor did not answer "
                             "through K1, K2, K3 and K4")
    for n, c in counts.items():
        results[n]["launches_cli"] = c
    xs = normalize_images(imgs[:32])
    hm_k = cli_r50.evaluator.forward(xs).float()
    with torch.no_grad():
        hm_p = cli_r50.evaluator.model(xs).float()
    _, mrel, meanrel = rel_err(hm_k, hm_p)
    log(f"cli.serve R50 heatmaps, kernel route vs the model's autocast "
        f"forward: max_rel {mrel:.4g} (<0.06), mean_rel {meanrel:.4g} "
        f"(<5e-3)")
    if not (torch.isfinite(hm_k).all() and mrel < 0.06 and meanrel < 5e-3):
        raise AssertionError("cli.serve R50 heatmaps disagree with the "
                             "model's own forward")
    del cli_r50, hm_k, hm_p
    torch.cuda.empty_cache()

    # -- phase 8: the ViTPose-S slice -----------------------------------------
    from tpupose_torch.models.backbones import vit as vit_mod
    from tpupose_torch.models.vitpose import ViTPose
    from tpupose_torch.ops.cuda_attention import flash_attention

    vmodel = ViTPose("vit_small", K, "classic", dtype=torch.bfloat16,
                     device="cuda", generator=torch.Generator().manual_seed(20))
    vpred = HeatmapPredictor(vmodel, (64, 48), flip_test=True)
    torch.cuda.synchronize()
    flash_attention.launches = dark_decode.launches = 0
    coords, scores = vpred(crops)
    counts = {"flash_attention": flash_attention.launches,
              "dark_decode": dark_decode.launches}
    log(f"ViTPose-S slice launches (B=32, flip): {counts}")
    if counts["flash_attention"] != 24 or counts["dark_decode"] <= 0:
        raise AssertionError(f"ViTPose-S path launches {counts}: expected "
                             f"24 of flash_attention and >0 of dark_decode")
    results["flash_attention"]["launches"] = counts["flash_attention"]
    results["dark_decode"]["launches_vitpose"] = counts["dark_decode"]
    if coords.shape != (32, K, 2) or not np.isfinite(coords).all() \
            or not np.isfinite(scores).all():
        raise AssertionError(f"bad ViTPose coords {coords.shape}")
    xs = normalize_images(imgs[:32])
    hm_k = vpred.evaluator.forward(xs).float()
    set_attention(vmodel, "plain")
    hm_p = vpred.evaluator.forward(xs).float()
    set_attention(vmodel, "kernel")
    _, mrel, meanrel = rel_err(hm_k, hm_p)
    log(f"ViTPose-S heatmaps, K8 route vs plain attention: max_rel "
        f"{mrel:.4g} (<0.06), mean_rel {meanrel:.4g} (<5e-3), shape "
        f"{tuple(hm_k.shape)}")
    if not (torch.isfinite(hm_k).all() and mrel < 0.06 and meanrel < 5e-3):
        raise AssertionError("ViTPose heatmaps: K8 route disagrees with the "
                             "plain-attention route")
    rates = {}
    for flip in (False, True):
        p = HeatmapPredictor(vmodel, (64, 48), flip_test=flip)
        rates[f"k8_flip{int(flip)}"] = img_per_s(p)
        set_attention(vmodel, "plain")
        rates[f"plain_flip{int(flip)}"] = img_per_s(p)
        set_attention(vmodel, "kernel")
        vit_mod.fused_attention = sdpa_attention
        try:
            rates[f"sdpa_flip{int(flip)}"] = img_per_s(p)
        finally:
            vit_mod.fused_attention = fused_attention
    log("ViTPose-S img/s at B=128 (uint8 host crops -> source coords on "
        "host; k8 = the port's route, plain = plain attention, sdpa = "
        "F.scaled_dot_product_attention, timed only): " + json.dumps(rates))
    serve_check(vpred, crops, "ViTPose-S")
    cfg = default_config()
    cfg.merge_dict(VITPOSE_S)
    cfg.freeze()
    cli_pred = build_predictor(cfg, "", device="cuda")
    flash_attention.launches = 0
    c1, s1 = cli_pred(crops[:1])
    log(f"cli.serve.build_predictor (vitpose_s config, flax init, bf16 "
        f"autocast): one request, {flash_attention.launches} K8 launches, "
        f"coords {c1.shape}")
    if c1.shape != (1, K, 2) or not np.isfinite(c1).all() \
            or flash_attention.launches != 24:
        raise AssertionError("cli.serve predictor did not answer through K8")
    del vmodel, vpred, cli_pred
    torch.cuda.empty_cache()

    # -- phase 10: the ViTPose-S training slice -------------------------------
    vit_train_phase(results)

    # -- phase 11: metric evaluation and the COCO-format data path, in a
    # child process: run in this one, it left torch.profiler dropping
    # device events in every phase-9 session after it (2 runs of 2) ---------
    phase11 = ROOT / "build" / "chip_smoke_phase11.json"
    subprocess.run([sys.executable, str(Path(__file__).resolve()),
                    "--phase11", str(out_dir / "default" / "ckpt"),
                    str(phase11)], check=True, timeout=900)
    for kernel, row in json.loads(phase11.read_text()).items():
        results[kernel].update(row)
    phase11.unlink()
    shutil.rmtree(out_dir, ignore_errors=True)

    # -- phase 9: device times, measured last so that no profiler session
    # precedes the timing of any other phase -----------------------------------
    k8_row = results["flash_attention"]
    hm = gaussian_maps(B, K, 64, 48, seed=2)
    frames = torch.randint(0, 256, (nf, FH, FW, 3), device="cuda",
                           dtype=torch.uint8,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    timed = [(results["dark_decode"], "device_ms", lambda: dark_decode(hm)),
             (results["affine_warp"], "device_ms",
              lambda: affine_warp(imgs, wm, (H, W))),
             (results["affine_warp"]["crops_from_frames"], "device_ms",
              lambda: crops_from_frames(frames, cm, (H, W)))]
    x1 = stem_pool_reference(normalize_images(imgs), fw["stem"])
    x2 = layer1_reference(x1, fw["layer1"])
    l1c = [as_conv_weights(w) for w in fw["layer1"]]
    brc = [as_conv_weights(fw["bridge"])]
    src_f = imgs.permute(0, 3, 1, 2).float().contiguous()
    grid = grid_for(wm, (H, W), (H, W))
    rep_f = frames.permute(0, 3, 1, 2).float().repeat_interleave(D, 0) \
        .contiguous()
    cgrid = grid_for(cm, (H, W), (FH, FW))

    def sample(src, grd):
        return F.grid_sample(src, grd, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    timed += [(results["stem_pool"], "device_ms",
               lambda: stem_pool(x0, fw["stem"])),
              (results["stem_pool"], "library_device_ms", lib_stem),
              (results["layer1"], "device_ms",
               lambda: layer1(x1, fw["layer1"])),
              (results["layer1"], "library_device_ms",
               lambda: library_blocks(x1, l1c, (1, 1, 1))),
              (results["bridge"], "device_ms",
               lambda: bridge(x2, fw["bridge"])),
              (results["bridge"], "library_device_ms",
               lambda: library_blocks(x2, brc, (2,))),
              (results["affine_warp"], "library_device_ms",
               lambda: sample(src_f, grid)),
              (results["affine_warp"]["crops_from_frames"],
               "library_device_ms", lambda: sample(rep_f, cgrid))]
    timed += [(k8_row, key, fn) for key, fn in k8_calls.items()]
    timed += [(k8_row["dinov3_640_vit_b"], key, fn)
              for key, fn in dino_calls.items()]
    k8b_row = results["flash_attention_bwd"]
    timed += [(k8b_row, key, fn) for key, fn in k8b_calls.items()]
    timed += [(k8b_row["dinov3_640_vit_b"], key, fn)
              for key, fn in k8b_dino_calls.items()]
    for row, call, bf16 in k5_device:
        timed += [(row, "device_ms", call), (row, "bf16_cudnn_device_ms", bf16)]
    for row, call, bf16, lib in k6_device:
        timed += [(row, "device_ms", call), (row, "bf16_cudnn_device_ms", bf16),
                  (row, "library_device_ms", lib)]
    sub_rows = {id(results["affine_warp"]["crops_from_frames"]):
                "affine_warp.crops_from_frames",
                id(k8_row["dinov3_640_vit_b"]): "flash_attention.dinov3",
                id(k8b_row["dinov3_640_vit_b"]): "flash_attention_bwd.dinov3"}
    for row, key, fn in timed:
        label = sub_rows.get(id(row)) or row["name"]
        row[key] = device_ms(fn, label=f"{label}.{key}")
    log("device ms under torch.profiler: " + json.dumps({
        "stem_pool": {k: results["stem_pool"][k]
                      for k in ("device_ms", "library_device_ms")},
        "layer1": {k: results["layer1"][k]
                   for k in ("device_ms", "library_device_ms")},
        "bridge": {k: results["bridge"][k]
                   for k in ("device_ms", "library_device_ms")},
        "affine_warp_grid_sample": results["affine_warp"]["library_device_ms"],
        "crops_from_frames_grid_sample":
            results["affine_warp"]["crops_from_frames"]["library_device_ms"],
        "dark_decode": results["dark_decode"]["device_ms"],
        "affine_warp": results["affine_warp"]["device_ms"],
        "crops_from_frames":
            results["affine_warp"]["crops_from_frames"]["device_ms"],
        "flash_attention": {k: k8_row[k] for k in k8_calls},
        "flash_attention_dinov3": {k: k8_row["dinov3_640_vit_b"][k]
                                   for k in dino_calls},
        "flash_attention_bwd": {k: k8b_row[k] for k in k8b_calls},
        "flash_attention_bwd_dinov3": {k: k8b_row["dinov3_640_vit_b"][k]
                                       for k in k8b_dino_calls},
        "run_chunk": {r["name"]: {k: r[k] for k in (
            "device_ms", "bf16_cudnn_device_ms", "ms", "bf16_cudnn_ms",
            "bound_ms")} for r, _, _ in k5_device},
        "run_deconv": {r["name"]: {k: r[k] for k in (
            "device_ms", "bf16_cudnn_device_ms", "library_device_ms", "ms",
            "bf16_cudnn_ms", "library_ms", "bound_ms")}
            for r, _, _, _ in k6_device}}))

    # -- phase 6 ---------------------------------------------------------------
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase11_main(ckpt_dir: Path, out_path: Path) -> int:
    """Phase 11 on its own (the child process main() starts): its rows
    of the kernels JSON go to `out_path`."""
    from tpupose_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    results = {n: {} for n in ("stem_pool", "layer1", "bridge", "dark_decode",
                               "affine_warp")}
    eval_phase(results, ckpt_dir)
    coco_phase(results)
    out_path.write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--phase11":
        sys.exit(phase11_main(Path(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
