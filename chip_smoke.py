"""End-to-end smoke run of tpupose_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and hidden):
  1. the card's name and power limit (nvidia-smi) and torch's device name;
  2. build every hand-written kernel from tpupose_torch/csrc with nvcc
     (into build/tpupose_torch/) and print the build seconds;
  3. each kernel of the SimpleBaseline-R50 256x192 serving path at B=128
     on seeded inputs: held against its plain PyTorch version at a stated
     tolerance, timed with CUDA events (median of 20 after warm-up) beside
     its plain version and, where one exists, the PyTorch library call
     that computes the same function (timed here as a yardstick only; the
     port never calls it), and its bound on the card;
  4. the slice: SimpleBaseline("resnet50", 17) in bf16 with seeded random
     weights and BatchNorm statistics, HeatmapPredictor with flip test on
     32 uint8 crops; every kernel's launch count is set to 0 before and
     must have risen after; the kernel forward's heatmaps are held against
     the model's plain forward (max rel 0.06, mean rel 5e-3, the bounds of
     tests/test_pallas_stem.py); coordinates must be finite, (32, 17, 2);
     img/s at B=128;
  5. PoseServer on 127.0.0.1 (ephemeral port): 8 concurrent .npy posts,
     17 keypoints each, and /stats must show coalesced batches;
  6. a JSON line of every kernel's numbers, then the last line
     {"ok": true, "device": {...}}.

Exits non-zero without printing a result where CUDA is unavailable. Needs
one card; imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# float32 non-tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"SXM": (989e12, 67e12, 3.35e12), "PCIe": (756e12, 51e12, 2.0e12)}
B = 128
H, W, K = 256, 192, 17


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.engine.server import PoseServer
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops import _build
    from tpupose_torch.ops.cuda_bridge import bridge, bridge_reference
    from tpupose_torch.ops.cuda_decode import (dark_decode,
                                               dark_decode_reference)
    from tpupose_torch.ops.cuda_layer1 import layer1, layer1_reference
    from tpupose_torch.ops.cuda_stem import (fold_fast_r50, stem_pool,
                                             stem_pool_reference)
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
    bf16_peak, f32_peak, hbm = PEAKS["PCIe" if "PCIe" in name else "SXM"]
    log(f"peaks used for bounds: bf16 {bf16_peak:.4g} FLOP/s, f32 "
        f"{f32_peak:.4g} FLOP/s, HBM {hbm:.4g} B/s")

    # -- phase 2: build ------------------------------------------------------
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{_build.build_seconds:.2f} s")

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
        dict(name="bridge", source="tpupose_torch/csrc/bottleneck.cu",
             replaces="tpupose/ops/pallas_bridge.py:106 _bridge_kernel "
                      "(bridge_pallas :144, pallas_call :159)",
             call=lambda: bridge(x2, fw["bridge"]),
             plain=lambda: bridge_reference(x2, fw["bridge"]),
             library=lambda: library_blocks(x2, brc, (2,)),
             flops=B * 2 * block_macs(fw["bridge"], p3, p2),
             nbytes=nbytes(x2, fw["bridge"]) + B * p3 * 512 * 2,
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

    rates = {}
    big = imgs.cpu().numpy()
    for flip in (False, True):
        p = HeatmapPredictor(model, (64, 48), flip_test=flip)
        for route in ("kernels", "plain"):
            if route == "plain":
                p.evaluator.fast_weights = None   # cuDNN forward, same model
            p(big)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 10
            for _ in range(n):
                p(big)
            dt = (time.perf_counter() - t0) / n
            rates[f"{route}_flip{int(flip)}"] = B / dt
    log("slice img/s at B=128 (uint8 host crops -> source coords on host): "
        + json.dumps(rates))

    # -- phase 5: the server ---------------------------------------------------
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
        raise AssertionError(f"server answers incomplete: {out}")
    if stats["requests"] != 8 or max(int(k) for k in stats["batch_hist"]) < 2:
        raise AssertionError(f"server did not coalesce: {stats}")
    log(f"server: 8 answers x {K} keypoints; stats {json.dumps(stats)}")

    # -- phase 6 ---------------------------------------------------------------
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
