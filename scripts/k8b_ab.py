"""K8b, the flash-attention backward (tpupose_torch/csrc/flash_attention_bwd.cu),
of this checkout against the same kernel of another checkout, on one
card, in turns.

    python3 scripts/k8b_ab.py --other <dir with the other csrc/> [--rounds 3]

`--other` names the other checkout's `tpupose_torch/csrc` (for example
the parent commit unpacked with `git archive` into build/). Both sources
are compiled with ops/_build.py's flags into build/k8b_ab/ and loaded with
ctypes (both keep the C signature of `tp_flash_attention_bwd`). On seeded
bf16 q/k/v (strided views of one projection, as RopeAttention cuts them)
and do at the ViTPose-S shape (128, 197, 6, 64) and the DINOv3 640x640
ViT-B shape (16, 1605, 12, 64), from this checkout's K8 forward (o and its
log-sum-exp), it checks that both backwards' dq, dk, dv lie within 2e-2
of the max |plain gradient| (float32 on the same bf16 inputs), that two
calls of this checkout's give the same bits, and times, by device time
under torch.profiler (chip_smoke.device_ms, all the launches of a
call), rounds of: this, the other, the other, this, and beside them the
autograd backward of F.scaled_dot_product_attention alone (a yardstick;
the port never calls it). It also splits this checkout's device time by
kernel (dq, dkv, and a Delta launch where a design has one). Prints the
card's name and power limit and one JSON line. Imports nothing of JAX.
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


def build(csrc: Path, tag: str) -> ctypes.CDLL:
    from tpupose_torch.ops import _build

    out = ROOT / "build" / "k8b_ab" / f"flash_attention_bwd_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-I", str(csrc), "-o",
                    str(out), str(csrc / "flash_attention_bwd.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    P, I, L, Fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_float)
    lib.tp_flash_attention_bwd.argtypes = ([P] * 10 + [I] * 3 + [L] * 9
                                           + [Fl, P])
    lib.tp_flash_attention_bwd.restype = ctypes.c_int
    return lib


def caller(lib, q, k, v, o, lse, do):
    B, L, H, _ = q.shape
    dq, dk, dv = (torch.empty_like(do) for _ in range(3))
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])

    def call():
        err = lib.tp_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, L, H, *strides, 0.125, stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
        return dq, dk, dv

    return call


def by_kernel(fn, iters=20):
    """Device ms per call of fn(), summed by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = "dkv" if "dkv" in e.name else "dq" if "dq_kernel" in \
                e.name else "delta" if "delta" in e.name else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / iters for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8b_ab: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from tpupose_torch.ops.attention import attention_backward_reference
    from tpupose_torch.ops.cuda_attention import _launch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    this = build(ROOT / "tpupose_torch" / "csrc", "this")
    other = build(Path(args.other), "other")
    out = {"card": torch.cuda.get_device_name(0), "other": args.other}
    for (B, L, H), seed in (((128, 197, 6), 8), ((16, 1605, 12), 9)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn((B, L, 3 * H * 64), generator=g, device="cuda") \
            .to(torch.bfloat16)
        q, k, v = qkv.view(B, L, 3, H, 64).unbind(2)
        do = torch.randn((B, L, H, 64), generator=g, device="cuda") \
            .to(torch.bfloat16)
        o, lse = _launch(q, k, v, 0.125, True)
        a, b = caller(this, q, k, v, o, lse, do), \
            caller(other, q, k, v, o, lse, do)
        want = attention_backward_reference(q.float(), k.float(), v.float(),
                                            do.float(), 0.125)
        errs = {}
        for name, fn in (("this", a), ("other", b)):
            got = [t.clone() for t in fn()]
            errs[name] = [((x.float() - w).abs().max()
                           / w.abs().max()).item()
                          for x, w in zip(got, want)]
            if name == "this":
                again = fn()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not (all(e <= 2e-2 for v_ in errs.values() for e in v_) and same):
            raise AssertionError(f"{(B, L, H)}: dq, dk, dv err / max |ref| "
                                 f"{errs} (tol 2e-2); deterministic {same}")
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, scale=0.125)
        do_t = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, leaves, do_t,
                                       retain_graph=True)

        rounds = []
        for _ in range(args.rounds):
            r = {"this": device_ms(a), "other": device_ms(b)}
            r["other_2"], r["this_2"] = device_ms(b), device_ms(a)
            r["sdpa_bwd"] = device_ms(sdpa_bwd)
            rounds.append(r)
        out[f"{B}x{L}x{H}"] = {"rel_err": errs, "deterministic": same,
                               "this_by_kernel": by_kernel(a),
                               "rounds": rounds}
        print(f"{(B, L, H)}: " + json.dumps(out[f"{B}x{L}x{H}"]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
