"""int8 ResNet bottleneck stages of the int8 serving engine (counterpart of
tpupose/ops/pallas_stages.py).

  - `quantize_per_col`: per-output-channel symmetric int8 in float64, an
    exact copy of the JAX function (max|k|/127, 1 where that is 0);
  - `build_stage`: the packer (counterpart of `build_stage_chunks`): a
    stage's folded weights, calibrated scales and input scale -> one
    `Int8Block` per bottleneck at the real widths, int8 weights in the
    kernel's [N][K] layout and float32 requant vectors computed in
    float64. The TPU-only devices of the JAX packer are not carried over:
    the 64 -> 128 lane padding, the 16*C phase layout of the stride-2 3x3
    (its zero rows leave the per-column scales unchanged, so the integers
    are the same), the selector matmuls and the VMEM-budget chunking;
  - `chunk_reference`: the plain version of one int8 bottleneck (mirrors
    `chunk_oracle`): exact int products (float64 on int values), then the
    float32 epilogue as separate multiply and add, in the kernel's order;
  - `run_chunk`: the wrapper of csrc/int8_bottleneck.cu, which replaces
    pallas_stages.py `_chunk_kernel`, one launch per bottleneck. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. `run_chunk.launches` counts launches. `pick_tile` chooses the
    kernel block's output tile (and images per block) at a launch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpupose_torch.ops import _build
from tpupose_torch.ops.quant import QMAX

# shared memory of csrc/int8_bottleneck.cu: an activation ring of 2 and a
# weight ring of 3 stages of 16 KB, then h0 and h1 (rows of cmid + 16
# bytes), the ring's 10 mbarriers and 1024 bytes of alignment slack
_RING_BYTES = 5 * 128 * 128
_SMEM_LIMIT = 232448
_MAPS_BYTES = 512           # four CUtensorMaps of the weights


def quantize_per_col(k: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: k (K, O) f64 -> (Wq int8, sw (O,))."""
    sw = np.abs(k).max(axis=0) / QMAX
    sw = np.where(sw == 0.0, 1.0, sw)
    wq = np.clip(np.round(k / sw), -QMAX, QMAX).astype(np.int8)
    return wq, sw


@dataclass
class Int8Block:
    """One packed int8 bottleneck. Weights int8 [N][K] (K contiguous): w1
    (cmid, cin), w2 (cmid, 9*cmid) with k = (dy*3+dx)*cmid + c, w3 (cout,
    cmid), wp (cout, cin); m*, b* float32 (N,). An identity block has no
    wp and adds x * r (r a float32 value)."""

    stride: int
    cin: int
    cmid: int
    cout: int
    w1: torch.Tensor
    m1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    m2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    m3: torch.Tensor
    b3: torch.Tensor
    wp: Optional[torch.Tensor] = None
    mp: Optional[torch.Tensor] = None
    bp: Optional[torch.Tensor] = None
    r: float = 0.0
    tmaps: Optional[torch.Tensor] = None

    def to(self, device) -> "Int8Block":
        """The block on `device`; on the card it also gets `tmaps`, the
        tensor maps of its weights (a CPU uint8 tensor), encoded once."""
        blk = replace(self, tmaps=None, **{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
            if f.name != "tmaps"
            and isinstance(getattr(self, f.name), torch.Tensor)})
        if blk.w1.device.type == "cuda":
            blk.tmaps = _weight_maps(blk)
        return blk


def _mat(kernel) -> np.ndarray:
    """torch conv kernel (O, I, kh, kw) -> (kh*kw*I, O) float64, rows
    [(dy*kw + dx)*I + c]."""
    k = np.asarray(torch.as_tensor(kernel).detach().cpu().double())
    return np.transpose(k, (2, 3, 1, 0)).reshape(-1, k.shape[0])


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float64).astype(np.float32))


def _i8(wq: np.ndarray) -> torch.Tensor:
    """(K, O) int8 -> the kernel's (O, K) contiguous layout."""
    return torch.from_numpy(np.ascontiguousarray(wq.T))


def _bias(b) -> np.ndarray:
    return np.asarray(torch.as_tensor(b).detach().cpu().double())


def build_stage(weights: Dict[str, tuple], conv_scale: Dict[str, float],
                add_scales: Dict[int, float], block_ids: Sequence[int],
                s_in: float, stride: int, block_prefix: str = "Bottleneck"
                ) -> Tuple[List[Int8Block], float]:
    """Pack one ResNet stage (blocks `block_ids` of the folded-weights dict
    of ops/int8_engine.fold_simple_baseline) -> (blocks, stage output
    scale). `s_in` is the input tensor's scale; the first block has the
    stage's stride. CPU tensors; `Int8Block.to` moves them."""
    blocks: List[Int8Block] = []
    s = s_in
    for j, n in enumerate(block_ids):
        base = f"{block_prefix}_{n}"
        k1, b1 = weights[f"{base}/c0"]
        k2, b2 = weights[f"{base}/c1"]
        k3, b3 = weights[f"{base}/c2"]
        k1, k2, k3 = _mat(k1), _mat(k2), _mat(k3)
        b1, b2, b3 = _bias(b1), _bias(b2), _bias(b3)
        s_c0 = conv_scale[f"{base}/c0"]
        s_c1 = conv_scale[f"{base}/c1"]
        s_add = add_scales[n]

        w1q, sw1 = quantize_per_col(k1)
        w2q, sw2 = quantize_per_col(k2)
        w3q, sw3 = quantize_per_col(k3)
        blk = Int8Block(
            stride=stride if j == 0 else 1, cin=k1.shape[0],
            cmid=k1.shape[1], cout=k3.shape[1],
            w1=_i8(w1q), m1=_f32(s * sw1 / s_c0), b1=_f32(b1 / s_c0),
            w2=_i8(w2q), m2=_f32(s_c0 * sw2 / s_c1), b2=_f32(b2 / s_c1),
            w3=_i8(w3q), m3=_f32(s_c1 * sw3 / s_add), b3=_f32(b3 / s_add))
        if f"{base}/proj" in weights:
            kp, bp = weights[f"{base}/proj"]
            wpq, swp = quantize_per_col(_mat(kp))
            blk.wp = _i8(wpq)
            blk.mp = _f32(s * swp / s_add)
            blk.bp = _f32(_bias(bp) / s_add)
        else:
            blk.r = float(np.float32(s / s_add))
        blocks.append(blk)
        s = s_add
    return blocks, s


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _rq(v: torch.Tensor) -> torch.Tensor:
    """clip(round(max(v, 0)), 0, 127), round half to even, float32."""
    return torch.clamp(torch.round(torch.clamp_min(v, 0.0)), 0.0, QMAX)


def _int_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) integer-valued @ w (N, K) int8 -> (..., N) float32: the
    int32 sum, exact in float64, then rounded to float32 once (as the
    kernel converts its int32 accumulator)."""
    return (a.double() @ w.double().t()).float()


def chunk_reference(x: torch.Tensor, blk: Int8Block) -> torch.Tensor:
    """Plain version of one int8 bottleneck: x (B, H, W, cin) int8 ->
    (B, Ho, Wo, cout) int8, Ho = (H-1)//stride + 1."""
    s = blk.stride
    B, H, W, _ = x.shape
    ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
    h0 = _rq(_int_product(x, blk.w1) * blk.m1 + blk.b1)
    hp = F.pad(h0, (0, 0, 1, 1, 1, 1))
    im = torch.cat([hp[:, dy:dy + s * (ho - 1) + 1:s,
                       dx:dx + s * (wo - 1) + 1:s]
                    for dy in range(3) for dx in range(3)], dim=-1)
    h1 = _rq(_int_product(im, blk.w2) * blk.m2 + blk.b2)
    y = _int_product(h1, blk.w3) * blk.m3 + blk.b3
    if blk.wp is None:
        res = x.float() * blk.r              # r is a float32 value
    else:
        res = _int_product(x[:, ::s, ::s], blk.wp) * blk.mp + blk.bp
    return _rq(y + res).to(torch.int8)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _geometry(th: int, tw: int, s: int) -> Tuple[int, int, int, int]:
    """csrc/int8_bottleneck.cu geometry: the halo's columns HC and rows HR,
    and conv1's bands: BR whole halo rows (BR * HC <= 128 GEMM rows), NBAND
    of them."""
    hc, hr = (tw - 1) * s + 3, (th - 1) * s + 3
    br = min(hr, 128 // hc)
    return hc, hr, br, -(-hr // br) if br else 0


def _smem_bytes(ni: int, th: int, tw: int, s: int, cmid: int) -> int:
    """csrc/int8_bottleneck.cu smem_bytes: the rings, h0 over the NI halos
    and h1 over the NI * TH * TW output rows (rows of cmid + 16 bytes), the
    barriers and the alignment slack."""
    hc, hr, _, _ = _geometry(th, tw, s)
    return (_RING_BYTES + (ni * hc * hr + ni * th * tw) * (cmid + 16)
            + 8 * 2 * 5 + 1024)


@functools.lru_cache(maxsize=None)
def pick_tile(batch: int, ho: int, wo: int, s: int, cin: int, cmid: int,
              cout: int, proj: bool) -> Tuple[int, int, int]:
    """The kernel block's work at one launch: a TH x TW output tile of NI
    images (NI > 1 only where the tile is the whole image), NI*TH*TW <= 128
    GEMM rows, within the card's 227 KB of shared memory. Chooses the least
    padded product work over the launch: each of conv1's bands and each
    pass of conv2 and conv3 costs two full 64-row M tiles; ties go to more
    rows a block. Cached: the run-time path asks at every launch."""
    best = None
    for th in (d for d in range(1, ho + 1) if ho % d == 0):
        for tw in (d for d in range(1, wo + 1) if wo % d == 0):
            whole = th == ho and tw == wo
            for ni in range(1, (128 // (th * tw) if whole else 1) + 1):
                m2 = ni * th * tw
                hc, _, _, nband = _geometry(th, tw, s)
                if m2 > 128 or hc > 128 \
                        or _smem_bytes(ni, th, tw, s, cmid) > _SMEM_LIMIT:
                    continue
                per_block = 128 * (ni * nband * cin * cmid + 9 * cmid * cmid
                                   + cmid * cout + (cin * cout if proj else 0))
                blocks = -(-batch // ni) * (ho // th) * (wo // tw)
                key = (blocks * per_block, -m2)
                if best is None or key < best[0]:
                    best = (key, (th, tw, ni))
    if best is None:
        raise ValueError(f"int8 bottleneck: no tile fits {ho}x{wo}, cmid "
                         f"{cmid}")
    return best[1]


def _weight_maps(blk: Int8Block) -> torch.Tensor:
    """The tensor maps of a card block's weights (512 host bytes)."""
    if blk.cin % 64 or (blk.cmid != 64 and blk.cmid % 128) or blk.cout % 128:
        raise ValueError(f"run_chunk: widths cin {blk.cin} (a multiple of "
                         f"64), cmid {blk.cmid} (64 or a multiple of 128), "
                         f"cout {blk.cout} (a multiple of 128) not taken")
    for k in ("w1", "w2", "w3", "wp"):
        t = getattr(blk, k)
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"run_chunk: {k} must be contiguous and 16-byte "
                             f"aligned")
    maps = torch.zeros(_MAPS_BYTES, dtype=torch.uint8)
    fn = _build.bind("int8_bottleneck.cu", "tp_int8_bottleneck_weight_maps",
                     [_build.PTR] * 4 + [_build.INT] * 3 + [_build.PTR])
    _build.check(fn(blk.w1.data_ptr(), blk.w2.data_ptr(), blk.w3.data_ptr(),
                    blk.wp.data_ptr() if blk.wp is not None else None,
                    blk.cin, blk.cmid, blk.cout, maps.data_ptr()),
                 "int8 bottleneck weight maps")
    return maps


def run_chunk(x: torch.Tensor, blk: Int8Block) -> torch.Tensor:
    """(B, H, W, cin) int8 -> (B, Ho, Wo, cout) int8. CPU: plain version;
    CUDA: one launch of the fused int8 bottleneck kernel."""
    if x.device.type == "cpu":
        return chunk_reference(x, blk)
    if x.device.type != "cuda":
        raise RuntimeError(f"run_chunk: unsupported device {x.device}")
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[-1] != blk.cin:
        raise ValueError(f"run_chunk: expected (B, H, W, {blk.cin}) int8, "
                         f"got {tuple(x.shape)} {x.dtype}")
    proj = blk.wp is not None
    shapes = {"w1": (blk.cmid, blk.cin), "w2": (blk.cmid, 9 * blk.cmid),
              "w3": (blk.cout, blk.cmid), "m1": (blk.cmid,),
              "b1": (blk.cmid,), "m2": (blk.cmid,), "b2": (blk.cmid,),
              "m3": (blk.cout,), "b3": (blk.cout,)}
    if proj:
        shapes.update(wp=(blk.cout, blk.cin), mp=(blk.cout,), bp=(blk.cout,))
    for k, shp in shapes.items():
        t = getattr(blk, k)
        want = torch.int8 if k[0] == "w" else torch.float32
        if tuple(t.shape) != shp or t.dtype != want or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"run_chunk: {k} must be {shp} {want} "
                             f"contiguous on {x.device}")
    if blk.tmaps is None:
        raise ValueError("run_chunk: the block must be moved to the card "
                         "with Int8Block.to, which encodes its tensor maps")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("run_chunk: x must be 16-byte aligned")
    B, H, W, _ = x.shape
    s = blk.stride
    ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
    out = torch.empty((B, ho, wo, blk.cout), dtype=torch.int8,
                      device=x.device)
    if B == 0:
        return out
    th, tw, ni = pick_tile(B, ho, wo, s, blk.cin, blk.cmid, blk.cout, proj)
    fn = _build.bind("int8_bottleneck.cu", "tp_int8_bottleneck",
                     [_build.PTR] * 10 + [_build.FLOAT, _build.PTR]
                     + [_build.INT] * 10 + [_build.PTR])
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    _build.check(fn(x.data_ptr(), blk.tmaps.data_ptr(), ptr(blk.m1),
                    ptr(blk.b1), ptr(blk.m2), ptr(blk.b2), ptr(blk.m3),
                    ptr(blk.b3), ptr(blk.mp), ptr(blk.bp), float(blk.r),
                    out.data_ptr(), B, H, W, blk.cin, blk.cmid, blk.cout, s,
                    th, tw, ni, _build.stream_of(x)), "run_chunk")
    run_chunk.launches += 1
    return out


run_chunk.launches = 0
