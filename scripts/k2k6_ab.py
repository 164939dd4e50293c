"""K2 (ResNet-50 layer1, tpupose_torch/csrc/bottleneck.cu) and K6 (the int8
deconv head, tpupose_torch/csrc/int8_deconv.cu) of this checkout against
the same kernels of another checkout, on one card, in turns.

    python3 scripts/k2k6_ab.py --other <dir with the other csrc/> [--rounds 3]

`--other` names the other checkout's `tpupose_torch/csrc` (for example the
parent commit unpacked with `git archive` into build/). Both checkouts'
sources are compiled with ops/_build.py's flags into build/k2k6_ab/ and
loaded with ctypes; both keep `tp_bottleneck`'s C signature, and
`tp_int8_deconv` is called with or without the block tile (TH, NI) as the
other source declares it. On the SimpleBaseline-R50 256x192 serving shapes
at B=128 (seeded as chip_smoke.py: bf16 model, layer1's input from the
plain stem, the int8 engine calibrated on 32 crops, each deconv's input
from the plain chain over seeded int8 input), it checks that both layer1s
lie within 2e-2 of layer1_reference (max abs over max |ref|) and that both
heads equal deconv_reference in every element, then times, by device time
under torch.profiler (chip_smoke.device_ms) in rounds of this, the other,
the other, this, and once by CUDA events: layer1's three launches beside
cuDNN's ten conv2d of the same folded blocks; each deconv and the head's
three beside bf16 cuDNN (ConvTranspose2d, the last with the final conv)
and the torch._int_mm chain (yardsticks; the port never calls them).
Prints the card's name and power limit and one JSON line. Imports nothing
of JAX.
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

B = 128


def build(csrc: Path, tag: str) -> dict:
    """Both sources of one checkout -> {source: (CDLL, deconv takes TH, NI)}."""
    from tpupose_torch.ops import _build

    out_dir = ROOT / "build" / "k2k6_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in ("bottleneck.cu", "int8_deconv.cu"):
        out = out_dir / f"{Path(src).stem}_{tag}.so"
        procs.append((src, out, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", str(csrc), "-o", str(out),
             str(csrc / src)])))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for src, out, p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"nvcc {csrc / src} failed")
        libs[src] = ctypes.CDLL(str(out))
    libs["bottleneck.cu"].tp_bottleneck.argtypes = [P] * 9 + [I] * 4 + [P]
    tiled = "int NI" in (csrc / "int8_deconv.cu").read_text()
    libs["int8_deconv.cu"].tp_int8_deconv.argtypes = \
        [P] * 8 + [I] * (9 if tiled else 7) + [P]
    libs["tiled"] = tiled
    return libs


def check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def layer1_caller(libs, x, ws):
    """layer1's three launches, outputs allocated once."""
    lib = libs["bottleneck.cu"]
    Bx, H, W, _ = x.shape
    outs = [torch.empty((Bx, H, W, 256), dtype=x.dtype, device=x.device)
            for _ in ws]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        y = x
        for i, (w, o) in enumerate(zip(ws, outs)):
            check(lib.tp_bottleneck(
                y.data_ptr(), w["w1"].data_ptr(), w["b1"].data_ptr(),
                w["w2"].data_ptr(), w["b2"].data_ptr(), w["w3"].data_ptr(),
                w["b3"].data_ptr(), w.get("wds", w["w3"]).data_ptr(),
                o.data_ptr(), 0 if i == 0 else 1, Bx, H, W, stream),
                "tp_bottleneck")
            y = o
        return y

    return call


def deconv_caller(libs, xs, specs):
    """One launch per (input, spec), the inputs given (not chained), so
    each deconv can be timed alone; outputs allocated once."""
    from tpupose_torch.ops.cuda_head import deconv_tile

    lib = libs["int8_deconv.cu"]
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for x, d in zip(xs, specs):
        Bx, h, w, _ = x.shape
        fin = d.wf is not None
        out = torch.empty((Bx, 2 * h, 2 * w, d.kf if fin else d.cout),
                          dtype=torch.float32 if fin else torch.int8,
                          device=x.device)
        ptr = (lambda t: t.data_ptr() if t is not None else None)
        args = [x.data_ptr(), ptr(d.w), ptr(d.mv), ptr(d.bv), ptr(d.wf),
                ptr(d.mf), ptr(d.bf), out.data_ptr(), Bx, h, w, d.cin,
                d.cout, d.kf, d.wf.shape[0] if fin else 0]
        if libs["tiled"]:
            args += list(deconv_tile(h, w))
        calls.append((args, out))

    def call(i):
        args, out = calls[i]
        check(lib.tp_int8_deconv(*args, stream), "tp_int8_deconv")
        return out

    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2k6_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import (as_conv_weights, cuda_ms, device_ms,
                            int_mm_deconv, library_blocks)
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops.cuda_engine import CudaServingEngine
    from tpupose_torch.ops.cuda_head import deconv_reference
    from tpupose_torch.ops.cuda_layer1 import layer1_reference
    from tpupose_torch.ops.cuda_stem import (fold_fast_r50,
                                             stem_pool_reference)
    from tpupose_torch.ops.int8_engine import fold_simple_baseline
    from tpupose_torch.ops.preprocess import normalize_images

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    this = build(ROOT / "tpupose_torch" / "csrc", "this")
    other = build(Path(args.other), "other")
    out = {"card": torch.cuda.get_device_name(0), "other": args.other,
           "batch": B}

    # -- K2 --------------------------------------------------------------
    model = SimpleBaseline("resnet50", 17, dtype=torch.bfloat16,
                           device="cuda",
                           generator=torch.Generator().manual_seed(0))
    fw = fold_fast_r50(model)
    imgs = torch.randint(0, 256, (B, 256, 192, 3), device="cuda",
                         dtype=torch.uint8,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    x1 = stem_pool_reference(normalize_images(imgs), fw["stem"])
    want = layer1_reference(x1, fw["layer1"]).float()
    a, b = (layer1_caller(t, x1, fw["layer1"]) for t in (this, other))
    errs = {n: ((fn().float() - want).abs().max() / want.abs().max()).item()
            for n, fn in (("this", a), ("other", b))}
    if not all(e <= 2e-2 for e in errs.values()):
        raise AssertionError(f"layer1: max rel {errs} (tol 2e-2)")
    convs = [as_conv_weights(w) for w in fw["layer1"]]

    def cudnn():
        return library_blocks(x1, convs, (1, 1, 1))

    rounds = []
    for _ in range(args.rounds):
        r = {"this": device_ms(a), "other": device_ms(b)}
        r["other_2"], r["this_2"] = device_ms(b), device_ms(a)
        r["cudnn"] = device_ms(cudnn)
        rounds.append(r)
    out["layer1"] = {"max_rel": errs, "device_rounds": rounds, "events": {
        "this": cuda_ms(a), "other": cuda_ms(b), "cudnn": cuda_ms(cudnn)}}
    print("layer1: " + json.dumps(out["layer1"]), flush=True)
    del x1, want, convs

    # -- K6 --------------------------------------------------------------
    model32 = SimpleBaseline("resnet50", 17, dtype=torch.float32,
                             device="cuda",
                             generator=torch.Generator().manual_seed(0))
    eng = CudaServingEngine.build(model32, imgs[:32])
    specs = list(eng.deconvs)
    xs = [torch.randint(0, 60, (B, 8, 6, specs[0].cin), device="cuda",
                        dtype=torch.int8,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(2))]
    for d in specs[:-1]:
        xs.append(deconv_reference(xs[-1], d))
    wants = [deconv_reference(x, d) for x, d in zip(xs, specs)]
    a, b = (deconv_caller(t, xs, specs) for t in (this, other))
    for name, fn in (("this", a), ("other", b)):
        for i, w in enumerate(wants):
            got = fn(i)
            if not torch.equal(got, w):
                raise AssertionError(f"deconv{i} ({name}): "
                                     f"{int((got != w).sum())} elements "
                                     f"differ from deconv_reference")
    _, fw32, _, _ = fold_simple_baseline(model)
    head_w = [tuple(t.to("cuda", torch.bfloat16)
                    for t in fw32[f"deconv{i}"]) for i in range(3)]
    fin_w = tuple(t.to("cuda", torch.bfloat16) for t in fw32["final"])
    xs_bf = [(x.float() * 0.05).to(torch.bfloat16).permute(0, 3, 1, 2)
             for x in xs]

    def cudnn_deconv(i):
        y = torch.relu(F.conv_transpose2d(xs_bf[i], *head_w[i], stride=2,
                                          padding=1))
        return F.conv2d(y, *fin_w) if i == 2 else y

    def int_mm(i):
        return int_mm_deconv(xs[i], specs[i])

    def chain(fn):
        return lambda: [fn(i) for i in range(3)]

    parts = {f"deconv{i}": (lambda i=i: a(i), lambda i=i: b(i),
                            lambda i=i: cudnn_deconv(i), lambda i=i: int_mm(i))
             for i in range(3)}
    parts["head"] = (chain(a), chain(b), chain(cudnn_deconv), chain(int_mm))
    for key, (fa, fb, fc, fi) in parts.items():
        rounds = []
        for _ in range(args.rounds):
            r = {"this": device_ms(fa), "other": device_ms(fb)}
            r["other_2"], r["this_2"] = device_ms(fb), device_ms(fa)
            r["bf16_cudnn"] = device_ms(fc)
            rounds.append(r)
        out[key] = {"device_rounds": rounds, "int_mm_device": device_ms(fi),
                    "events": {"this": cuda_ms(fa), "other": cuda_ms(fb),
                               "bf16_cudnn": cuda_ms(fc),
                               "int_mm": cuda_ms(fi)}}
        print(f"{key}: " + json.dumps(out[key]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
