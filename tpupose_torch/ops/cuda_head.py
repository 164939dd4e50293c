"""int8 deconv head of the int8 serving engine (counterpart of
tpupose/ops/pallas_head.py): 3x ConvTranspose 4x4/2 + BN + ReLU, the
final 1x1 heatmap conv fused into the last one.

A stride-2 transposed conv splits into four output phases; phase (p, q)
is one (4*Cin)-deep product over the 2x2 shifted inputs. For the torch
`ConvTranspose2d(k=4, s=2, padding=1)` kernel (the flax kernel rotated
180 degrees), per axis:

  out[2i]   = x[i-1] @ w[3] + x[i]   @ w[1]
  out[2i+1] = x[i]   @ w[2] + x[i+1] @ w[0]

which is `_TAPS` below: the JAX table with every tap t replaced by 3 - t,
the shifts in the same order, so the phase matrices and their int8 values
are the JAX package's.

  - `fold_deconv` / `build_deconv_spec`: per-phase, per-column int8
    weights (each of the four (4*Cin, O) phase matrices has its own scale
    vector) in the kernel's [N][K] layout, requant vectors in float64 then
    float32; the final conv with its own `quantize_per_col` and
    mf = s_in_final * swf;
  - `deconv_reference`: the plain version (mirrors `deconv_oracle`),
    exact int products then the float32 epilogue in the kernel's order;
  - `run_deconv`: the wrapper of csrc/int8_deconv.cu (int8 wgmma on
    TMA-fed operands), which replaces pallas_head.py `_deconv_kernel`. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. `run_deconv.launches` counts launches. `deconv_tile`
    chooses a kernel work item's input rows, `_smem_bytes` mirrors the
    kernel's shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from itertools import product
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpupose_torch.ops import _build
from tpupose_torch.ops.cuda_stages import (_f32, _i8, _int_product, _rq,
                                           quantize_per_col)

# per output parity: (input shift, torch kernel tap) pairs along one axis
_TAPS = (((-1, 3), (0, 1)), ((0, 2), (1, 0)))

# csrc/int8_deconv.cu: 192 GEMM rows an item, a ring of 4 stages of 192 +
# 128 rows of 128 K bytes, output tiles of 192 rows x 128 channels, the
# final conv's 32 x O weights, 9 mbarriers, 1024 bytes of alignment slack
_ROWS = 192


def _smem_bytes(o: int, fin: bool) -> int:
    """Shared memory of one int8 deconv block (csrc/int8_deconv.cu
    smem_bytes): O output channels, with or without the final conv."""
    tiles = o // 128 if fin else 1
    return (4 * (_ROWS + 128) * 128 + tiles * _ROWS * 128
            + (32 * o if fin else 0) + 8 * 9 + 1024)


def deconv_tile(h: int, w: int) -> Tuple[int, int]:
    """A kernel work item's GEMM rows: TH whole input rows of NI images (TH
    divides h, NI > 1 only where TH == h), as many as fit 192 rows: NI
    images where a whole image fits, else the largest TH."""
    if w > _ROWS:
        raise ValueError(f"run_deconv: input width {w} > {_ROWS} not taken")
    if h * w <= _ROWS:
        return h, _ROWS // (h * w)
    return max(d for d in range(1, h + 1) if h % d == 0 and d * w <= _ROWS), 1


@dataclass
class DeconvSpec:
    """One int8 transposed conv: w (4, O, 4*Cin) int8 (phase 2p+q), mv
    (4, O), bv (O,) float32; with the fused final conv also wf (KP, O)
    int8, mf, bf (KP,) float32, KP = kf rounded up to 32 (zero rows)."""

    cin: int
    cout: int
    w: torch.Tensor
    mv: torch.Tensor
    bv: torch.Tensor
    kf: int = 0                  # heatmap channels of the fused conv (0 = none)
    wf: Optional[torch.Tensor] = None
    mf: Optional[torch.Tensor] = None
    bf: Optional[torch.Tensor] = None

    def to(self, device) -> "DeconvSpec":
        return replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _np(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).detach().cpu().double())


def fold_deconv(kernel, bias, s_in: float, s_out: float):
    """kernel (Cin, O, 4, 4) folded-BN torch ConvTranspose2d weight, bias
    (O,); s_in/s_out the calibrated scales of the input and output ->
    (w (4, O, 4*Cin) int8, mv (4, O), bv (O,) float32)."""
    k, b = _np(kernel), _np(bias)
    cin, o = k.shape[:2]
    ws, ms = [], []
    for p in range(2):
        for q in range(2):
            w = np.zeros((4 * cin, o), np.float64)
            for bi, ((_, ty), (_, tx)) in enumerate(
                    product(_TAPS[p], _TAPS[q])):
                w[bi * cin:(bi + 1) * cin] = k[:, :, ty, tx]
            wq, sw = quantize_per_col(w)
            ws.append(_i8(wq))
            ms.append(_f32(s_in * sw / s_out))
    return torch.stack(ws), torch.stack(ms), _f32(b / s_out)


def build_deconv_spec(kernel, bias, s_in: float, s_out: float,
                      final: Optional[tuple] = None) -> DeconvSpec:
    """final = (kernel (K, O, 1, 1), bias (K,), s_in_final) fuses the
    heatmap conv (float32 output, K channels)."""
    w, mv, bv = fold_deconv(kernel, bias, s_in, s_out)
    spec = DeconvSpec(int(w.shape[2]) // 4, int(w.shape[1]), w, mv, bv)
    if final is not None:
        kf, bf, sf = final
        kf = _np(kf)[:, :, 0, 0].T                     # (O, K)
        wfq, swf = quantize_per_col(kf)
        k = kf.shape[1]
        kp = -(-k // 32) * 32
        pad = kp - k
        spec.kf = k
        spec.wf = _i8(np.pad(wfq, ((0, 0), (0, pad))))
        spec.mf = _f32(np.pad(sf * swf, (0, pad)))
        spec.bf = _f32(np.pad(_np(bf), (0, pad)))
    return spec


def deconv_reference(x: torch.Tensor, spec: DeconvSpec) -> torch.Tensor:
    """Plain version: x (B, h, w, Cin) int8 -> (B, 2h, 2w, O) int8, or
    float32 heatmaps (B, 2h, 2w, kf) with the fused final conv."""
    B, h, w, _ = x.shape
    hp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.empty((B, 2 * h, 2 * w, spec.cout), dtype=torch.float32,
                      device=x.device)
    for p in range(2):
        for q in range(2):
            im = torch.cat([hp[:, 1 + my:1 + my + h, 1 + mx:1 + mx + w]
                            for ((my, _), (mx, _)) in product(_TAPS[p],
                                                               _TAPS[q])],
                           dim=-1)
            ph = 2 * p + q
            out[:, p::2, q::2] = _rq(_int_product(im, spec.w[ph])
                                     * spec.mv[ph] + spec.bv)
    if spec.wf is None:
        return out.to(torch.int8)
    hm = _int_product(out, spec.wf) * spec.mf + spec.bf
    return hm[..., :spec.kf].contiguous()


def run_deconv(x: torch.Tensor, spec: DeconvSpec) -> torch.Tensor:
    """(B, h, w, Cin) int8 -> (B, 2h, 2w, O) int8, or (B, 2h, 2w, kf)
    float32 with the fused final conv. CPU: plain version; CUDA: one
    launch of the int8 deconv kernel (Cin and O multiples of 128; with the
    final conv O at most 256 and kf at most 32)."""
    if x.device.type == "cpu":
        return deconv_reference(x, spec)
    if x.device.type != "cuda":
        raise RuntimeError(f"run_deconv: unsupported device {x.device}")
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[-1] != spec.cin:
        raise ValueError(f"run_deconv: expected (B, h, w, {spec.cin}) int8, "
                         f"got {tuple(x.shape)} {x.dtype}")
    o, fin = spec.cout, spec.wf is not None
    shapes = {"w": (4, o, 4 * spec.cin), "mv": (4, o), "bv": (o,)}
    if fin:
        kp = spec.wf.shape[0]
        shapes.update(wf=(kp, o), mf=(kp,), bf=(kp,))
    for k, shp in shapes.items():
        t = getattr(spec, k)
        want = torch.int8 if k[0] == "w" else torch.float32
        if tuple(t.shape) != shp or t.dtype != want or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"run_deconv: {k} must be {shp} {want} "
                             f"contiguous on {x.device}")
    if spec.cin % 128 or o % 128 or (fin and (
            o > 256 or spec.wf.shape[0] != 32 or not 1 <= spec.kf <= 32)):
        raise ValueError(f"run_deconv: cin {spec.cin} and cout {o} must be "
                         f"multiples of 128; with the final conv cout <= 256 "
                         f"and 1 <= kf <= 32 (KP 32)")
    x = x.contiguous()
    B, h, w, _ = x.shape
    out = torch.empty((B, 2 * h, 2 * w, spec.kf if fin else o),
                      dtype=torch.float32 if fin else torch.int8,
                      device=x.device)
    if B == 0:
        return out
    if x.data_ptr() % 16 or spec.w.data_ptr() % 16 \
            or (fin and spec.wf.data_ptr() % 16):
        raise ValueError("run_deconv: x and the weights must be 16-byte "
                         "aligned")
    th, ni = deconv_tile(h, w)
    fn = _build.bind("int8_deconv.cu", "tp_int8_deconv",
                     [_build.PTR] * 8 + [_build.INT] * 9 + [_build.PTR])
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    _build.check(fn(x.data_ptr(), ptr(spec.w), ptr(spec.mv), ptr(spec.bv),
                    ptr(spec.wf), ptr(spec.mf), ptr(spec.bf), out.data_ptr(),
                    B, h, w, spec.cin, o, spec.kf,
                    spec.wf.shape[0] if fin else 0, th, ni,
                    _build.stream_of(x)),
                 "run_deconv")
    run_deconv.launches += 1
    return out


run_deconv.launches = 0
