"""K1 (the fused stem, tpupose_torch/csrc/stem.cu) and K7 (the affine warp,
tpupose_torch/csrc/warp.cu) of this checkout against the same kernels of
another checkout, on one card, in turns.

    python3 scripts/k1k7_ab.py --other <dir with the other csrc/> [--rounds 3]
        [--k7-variant NAME=-DK7_FOOT=0 ...]

`--other` names the other checkout's `tpupose_torch/csrc` (for example the
parent commit unpacked with `git archive` into build/). Both checkouts'
sources are compiled with ops/_build.py's flags into build/k1k7_ab/ and
loaded with ctypes; `tp_stem_pool` is called with or without the wgmma N
(ops/cuda_stem.stem_tile), and `tp_affine_warp` with or without the
gather counter, as each source declares them. Each `--k7-variant`
builds this checkout's warp.cu once more with the given nvcc flags (the
K7_TW, K7_TH and K7_FOOT settings at the top of warp.cu; K7_FOOT=0: no
staging, every tile gathers from device memory) and times it beside the
others. At B=128, seeded as chip_smoke.py (bf16 model, uint8 crops; the
warp's matrices rotate up to +-60 degrees and scale 0.65-1.35; the crops
cut 4 person boxes from each of 32 frames of 480x640), it checks that
both stems lie within 1e-2 of stem_pool_reference (max abs over max
|ref|) at 256x192 (simple_baseline.yaml) and 256x256
(simple_baseline_mpii.yaml), and that every warp equals its plain
version in every element, then times, by device time under
torch.profiler (chip_smoke.device_ms) in rounds of this, the other, the
other, this (then each variant), and once by CUDA events: the stem beside
conv2d + relu + max_pool2d (cuDNN, bf16), each warp beside F.grid_sample
on a float32 NCHW copy (yardsticks; the port never calls them). For each
warp of this checkout it reports the tiles that gathered from device
memory. Beside the warps, two floors of their traffic: the uint8 batch
cast to float32 (`.float()`: the same bytes read and written, coalesced)
and a fill of the float32 output alone. Prints the card's name and power
limit and one JSON line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B, H, W = 128, 256, 192


def build(csrc: Path, tag: str, variants=()) -> dict:
    """Both sources of one checkout, and warp.cu once more for each (name,
    flags) of `variants` -> {source or "warp.cu:name": CDLL, "nt": stem
    takes N, "counter": the warp takes the gather counter}."""
    from tpupose_torch.ops import _build

    out_dir = ROOT / "build" / "k1k7_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [("stem.cu", "stem.cu", []), ("warp.cu", "warp.cu", [])]
    jobs += [(f"warp.cu:{name}", "warp.cu", flags.split())
             for name, flags in variants]
    procs = []
    for i, (key, src, flags) in enumerate(jobs):
        out = out_dir / f"{tag}_{i}_{Path(src).stem}.so"
        procs.append((key, out, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, *flags, "-I", str(csrc), "-o",
             str(out), str(csrc / src)])))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {"nt": "int nt" in (csrc / "stem.cu").read_text(),
            "counter": "gathered" in (csrc / "warp.cu").read_text()}
    for key, out, p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"nvcc {key} of {csrc} failed")
        libs[key] = ctypes.CDLL(str(out))
        if key == "stem.cu":
            libs[key].tp_stem_pool.argtypes = \
                [P] * 4 + [I] * (4 if libs["nt"] else 3) + [P]
        else:
            libs[key].tp_affine_warp.argtypes = \
                [P] * 3 + [I] * 8 + [P] * (2 if libs["counter"] else 1)
    return libs


def check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stem_caller(libs, x, w):
    from tpupose_torch.ops.cuda_stem import _pooled, stem_tile

    Bx, h, wd, _ = x.shape
    out = torch.empty((Bx, _pooled(h), _pooled(wd), 64), dtype=x.dtype,
                      device=x.device)
    args = [x.data_ptr(), w["w"].data_ptr(), w["bias"].data_ptr(),
            out.data_ptr(), Bx, h, wd]
    if libs["nt"]:
        args.append(stem_tile(h, wd)[0])
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        check(libs["stem.cu"].tp_stem_pool(*args, stream), "tp_stem_pool")
        return out

    return call


def warp_caller(libs, src, mats, D, key="warp.cu", counter=None):
    N = mats.shape[0]
    _, hs, ws, c = src.shape
    out = torch.empty((N, H, W, c), dtype=torch.float32, device=src.device)
    args = [src.data_ptr(), mats.data_ptr(), out.data_ptr(),
            int(src.dtype == torch.uint8), N, hs, ws, c, H, W, D]
    if libs["counter"]:
        args.append(None if counter is None else counter.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        check(libs[key].tp_affine_warp(*args, stream), "tp_affine_warp")
        return out

    return call


def gathered_tiles(libs, src, mats, D, key):
    """Tiles of one call of this checkout's warp `key` that gathered from
    device memory."""
    cnt = torch.zeros(1, dtype=torch.int32, device=src.device)
    warp_caller(libs, src, mats, D, key, cnt)()
    return int(cnt.item())


def rounds_of(a, b, lib, n, lib_key, extra=None):
    from chip_smoke import device_ms

    rounds = []
    for _ in range(n):
        r = {"this": device_ms(a, label="this"),
             "other": device_ms(b, label="other")}
        r["other_2"] = device_ms(b, label="other")
        r["this_2"] = device_ms(a, label="this")
        for name, fn in (extra or {}).items():
            r[name] = device_ms(fn, label=name)
        r[lib_key] = device_ms(lib, label=lib_key)
        rounds.append(r)
    return rounds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--k7-variant", action="append", default=[],
                    metavar="NAME=FLAGS",
                    help="also time this checkout's warp.cu built with "
                         "these nvcc flags, e.g. nofoot=-DK7_FOOT=0")
    args = ap.parse_args()
    variants = [v.split("=", 1) for v in args.k7_variant]
    if not torch.cuda.is_available():
        print("k1k7_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, grid_for, warp_mats
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops.affine import batched_affine_warp, get_affine_matrix
    from tpupose_torch.ops.cuda_stem import fold_fast_r50, stem_pool_reference
    from tpupose_torch.ops.cuda_warp import _plain_crops
    from tpupose_torch.ops.preprocess import normalize_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    this = build(ROOT / "tpupose_torch" / "csrc", "this", variants)
    other = build(Path(args.other), "other")
    out = {"card": torch.cuda.get_device_name(0), "other": args.other,
           "batch": B}

    # -- K1 --------------------------------------------------------------
    model = SimpleBaseline("resnet50", 17, dtype=torch.bfloat16,
                           device="cuda",
                           generator=torch.Generator().manual_seed(0))
    sw = fold_fast_r50(model)["stem"]
    stem_c = sw["w"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    stem_b = sw["bias"].to(torch.bfloat16)
    for key, (h, w) in (("stem_pool", (H, W)),
                        ("stem_pool_256x256", (256, 256))):
        raw = torch.randint(0, 256, (B, h, w, 3), device="cuda",
                            dtype=torch.uint8,
                            generator=torch.Generator(device="cuda")
                            .manual_seed(1))
        if (h, w) == (H, W):
            imgs = raw                  # the warps' source below
        x0 = normalize_images(raw)
        want = stem_pool_reference(x0, sw).float()
        a, b = (stem_caller(t, x0, sw) for t in (this, other))
        errs = {n: ((fn().float() - want).abs().max()
                    / want.abs().max()).item()
                for n, fn in (("this", a), ("other", b))}
        if not all(e <= 1e-2 for e in errs.values()):
            raise AssertionError(f"{key}: max rel {errs} (tol 1e-2)")

        def cudnn(x0=x0):
            y = F.conv2d(x0.permute(0, 3, 1, 2), stem_c, stem_b, 2, 3)
            return F.max_pool2d(torch.relu(y), 3, 2, 1)

        out[key] = {
            "max_rel": errs, "device_rounds": rounds_of(
                a, b, cudnn, args.rounds, "cudnn"),
            "events": {"this": cuda_ms(a), "other": cuda_ms(b),
                       "cudnn": cuda_ms(cudnn)}}
        print(f"{key}: " + json.dumps(out[key]), flush=True)
        del x0, want
    del model

    # -- K7 --------------------------------------------------------------
    wm = warp_mats(B, H, W, seed=3)
    nf, D, FH, FW = 32, 4, 480, 640
    frames = torch.randint(0, 256, (nf, FH, FW, 3), device="cuda",
                           dtype=torch.uint8,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    gb = torch.Generator().manual_seed(5)
    hgt = 150 + 300 * torch.rand(nf * D, generator=gb)
    centers = torch.stack([80 + 480 * torch.rand(nf * D, generator=gb),
                           80 + 320 * torch.rand(nf * D, generator=gb)], -1)
    cm = get_affine_matrix(centers, torch.stack([hgt * W / H, hgt], -1),
                           0.0, (H, W)).cuda()
    src_f = imgs.permute(0, 3, 1, 2).float().contiguous()
    rep_f = frames.permute(0, 3, 1, 2).float().repeat_interleave(D, 0) \
        .contiguous()
    grid, cgrid = grid_for(wm, (H, W), (H, W)), grid_for(cm, (H, W), (FH, FW))
    cases = {
        "affine_warp": (imgs, wm, 1, batched_affine_warp(imgs, wm, (H, W)),
                        lambda: F.grid_sample(src_f, grid, mode="bilinear",
                                              padding_mode="zeros",
                                              align_corners=True)),
        "crops_from_frames": (frames, cm, D, _plain_crops(frames, cm, (H, W)),
                              lambda: F.grid_sample(rep_f, cgrid,
                                                    mode="bilinear",
                                                    padding_mode="zeros",
                                                    align_corners=True))}
    for key, (src, mats, d, plain, lib) in cases.items():
        a, b = (warp_caller(t, src, mats, d) for t in (this, other))
        extra = {name: warp_caller(this, src, mats, d, f"warp.cu:{name}")
                 for name, _ in variants}
        for name, fn in (("this", a), ("other", b), *extra.items()):
            nbad = int((fn() != plain).sum())
            if nbad:
                raise AssertionError(f"{key} ({name}): {nbad} elements "
                                     f"differ from the plain version")
        out[key] = {"device_rounds": rounds_of(a, b, lib, args.rounds,
                                               "grid_sample", extra),
                    "events": {"this": cuda_ms(a), "other": cuda_ms(b),
                               "grid_sample": cuda_ms(lib)}}
        if this["counter"]:
            out[key]["gathered_tiles"] = {
                name: gathered_tiles(this, src, mats, d, k)
                for name, k in (("this", "warp.cu"),
                                *((n, f"warp.cu:{n}") for n, _ in variants))}
        print(f"{key}: " + json.dumps(out[key]), flush=True)
    from chip_smoke import device_ms

    dst = torch.empty((B, H, W, 3), device="cuda")
    out["traffic_floors"] = {
        "uint8_to_float32": device_ms(lambda: imgs.float(),
                                      label="uint8_to_float32"),
        "fill_float32": device_ms(lambda: dst.fill_(1.0),
                                  label="fill_float32")}
    print("traffic floors: " + json.dumps(out["traffic_floors"]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
