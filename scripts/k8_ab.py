"""K8, the flash-attention forward (tpupose_torch/csrc/flash_attention.cu),
of this checkout against the same kernel of another checkout, on one
card, in turns.

    python3 scripts/k8_ab.py --other <dir with the other csrc/> [--rounds 4]

`--other` names the other checkout's `tpupose_torch/csrc` (for example
the parent commit unpacked with `git archive` into build/). Both sources
are compiled with ops/_build.py's flags into build/k8_ab/ and loaded with
ctypes; the script detects which C signature each has (the LSE pointer
came with the backward, K8b). On seeded bf16 q/k/v at the ViTPose-S shape
(128, 197, 6, 64) and the DINOv3 640x640 ViT-B shape (16, 1605, 12, 64)
it checks that both o agree with the plain version (float32 on the same
bf16 inputs) within 2e-2, as chip_smoke.py holds K8 (two designs sum in
other orders, so they need not agree bit for bit), and times, by device
time under torch.profiler (chip_smoke.device_ms), rounds of: this
checkout without the LSE, the other, the other, this checkout without
the LSE, then this checkout with the LSE (the training forward). Prints
the card's name and power limit and one JSON line. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(csrc: Path, tag: str) -> ctypes.CDLL:
    from tpupose_torch.ops import _build

    out = ROOT / "build" / "k8_ab" / f"flash_attention_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", str(csrc), "-o",
                    str(out), str(csrc / "flash_attention.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    with_lse = "void* lse" in (csrc / "flash_attention.cu").read_text()
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_float)
    lib.tp_flash_attention.argtypes = ([P] * 4 + [I] * 3 + [L] * 9 + [F]
                                       + ([P] if with_lse else []) + [P])
    lib.tp_flash_attention.restype = ctypes.c_int
    lib.with_lse = with_lse
    return lib


def caller(lib, q, k, v, lse=None):
    B, L, H, _ = q.shape
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    extra = [lse.data_ptr() if lse is not None else None] \
        if lib.with_lse else []

    def call():
        err = lib.tp_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), B, L, H, *strides, 0.125,
                                     *extra, stream)
        if err:
            raise RuntimeError(f"flash_attention: CUDA error {err}")
        return o

    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from tpupose_torch.ops.attention import attention_reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    this = build(ROOT / "tpupose_torch" / "csrc", "this")
    other = build(Path(args.other), "other")
    out = {"card": torch.cuda.get_device_name(0), "other": args.other}
    for (B, L, H), seed in (((128, 197, 6), 6), ((16, 1605, 12), 7)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn((B, L, 3 * H * 64), generator=g, device="cuda") \
            .to(torch.bfloat16)
        q, k, v = qkv.view(B, L, 3, H, 64).unbind(2)
        lse = torch.empty((B, H, L), dtype=torch.float32, device="cuda")
        a, b = caller(this, q, k, v), caller(other, q, k, v)
        a_lse = caller(this, q, k, v, lse)
        want = attention_reference(q.float(), k.float(), v.float(), 0.125)
        errs = {name: (fn().float() - want).abs().max().item()
                for name, fn in (("this", a), ("other", b),
                                 ("this_lse", a_lse))}
        if not all(e <= 2e-2 for e in errs.values()):
            raise AssertionError(f"{(B, L, H)}: max abs err vs the plain "
                                 f"version {errs} (tol 2e-2)")
        rounds = []
        for _ in range(args.rounds):
            r = {"this": device_ms(a), "other": device_ms(b)}
            r["other_2"], r["this_2"] = device_ms(b), device_ms(a)
            r["this_lse"] = device_ms(a_lse)
            rounds.append(r)
        out[f"{B}x{L}x{H}"] = {"max_abs_err": errs, "rounds": rounds}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
