"""ResNet-50 block2_0, the "bridge" from layer1 to layer2 (counterpart of
tpupose/ops/pallas_bridge.py): 1x1 256->128, 3x3/2 128->128,
1x1 128->512, plus the 1x1/2 downsample 256->512, add, ReLU.

  - `fold_bridge_weights`: the block's conv + BN pairs folded (see
    cuda_layer1.fold_bottleneck); for weights on the card, also the TMA
    tensor maps of the four weight matrices, encoded once (`tmaps`);
  - `bridge_reference`: the plain PyTorch version;
  - `bridge`: the wrapper of csrc/bridge.cu (wgmma products fed by TMA,
    a cluster of two blocks sharing each weight tile), which replaces
    pallas_bridge.py `_bridge_kernel`, through the torch.library op
    `tpupose_torch::bridge` (`bridge_op`) where a program is traced, its
    body straight in an eager call (_build.op_or_body). CPU tensors take
    the plain
    version; CUDA tensors launch the kernel or raise. `bridge.launches`
    counts launches.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from tpupose_torch.ops import _build
from tpupose_torch.ops.cuda_layer1 import (bottleneck_reference,
                                           fold_bottleneck)

CIN, CM, COUT, TILE = 256, 128, 512, 8
_SHAPES = {"w1": (CIN, CM), "w2": (3, 3, CM, CM), "w3": (CM, COUT),
           "wds": (CIN, COUT), "b1": (CM,), "b2": (CM,), "b3": (COUT,)}
_MAPS_BYTES = 4 * 128               # four CUtensorMap


def _check_weights(w: dict, device):
    for k, shp in _SHAPES.items():
        t = w[k]
        want = torch.float32 if k[0] == "b" else torch.bfloat16
        if tuple(t.shape) != shp or t.dtype != want or t.device != device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bridge: weight {k} must be {shp} {want}, "
                             f"contiguous and 16-byte aligned on {device}")


_MAPS_CACHE: OrderedDict = OrderedDict()     # weight pointers -> maps
_MAPS_CACHE_SIZE = 16


def weight_maps(w: dict) -> torch.Tensor:
    """The TMA tensor maps of a folded block's four bf16 weight matrices
    on the card (a CPU uint8 tensor), encoded once per set of weight
    addresses: a map holds an address, shape and strides, never values,
    so equal addresses of these fixed shapes give the same maps."""
    key = (w["w1"].device.index,) + tuple(
        w[k].data_ptr() for k in ("w1", "w2", "w3", "wds"))
    maps = _MAPS_CACHE.get(key)
    if maps is None:
        maps = torch.zeros(_MAPS_BYTES, dtype=torch.uint8)
        fn = _build.bind("bridge.cu", "tp_bridge_weight_maps",
                         [_build.PTR] * 5)
        _build.check(fn(w["w1"].data_ptr(), w["w2"].data_ptr(),
                        w["w3"].data_ptr(), w["wds"].data_ptr(),
                        maps.data_ptr()), "bridge weight maps")
        _MAPS_CACHE[key] = maps
        while len(_MAPS_CACHE) > _MAPS_CACHE_SIZE:
            _MAPS_CACHE.popitem(last=False)
    _MAPS_CACHE.move_to_end(key)
    return maps


def fold_bridge_weights(backbone, dtype=None) -> dict:
    """layer2 block 0 of a ResNet-50 -> folded weights; bf16 weights on the
    card also get `tmaps`, their tensor maps (a CPU uint8 tensor)."""
    w = fold_bottleneck(backbone.layer2[0], dtype)
    if w["w1"].device.type == "cuda" and w["w1"].dtype == torch.bfloat16:
        _check_weights(w, w["w1"].device)
        w["tmaps"] = weight_maps(w)
    return w


def bridge_reference(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """Plain version: (B, H, W, 256) -> (B, H/2, W/2, 512), x.dtype."""
    return bottleneck_reference(x, weights, 2)


def bridge_impl(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                b3: torch.Tensor, wds: torch.Tensor) -> torch.Tensor:
    """The body of K3's torch.library op `bridge_op`: a CPU tensor takes the plain version, a
    CUDA tensor one launch of the csrc/bridge.cu kernel or raises. The
    tensor maps come from `weight_maps` of the weights given, so a loaded
    program's weights (at other addresses than at tracing) get their own.
    `bridge.launches` rises at each launch."""
    weights = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3,
               "wds": wds}
    if x.device.type == "cpu":
        return bridge_reference(x, weights)
    if x.device.type != "cuda":
        raise RuntimeError(f"bridge: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != CIN:
        raise ValueError(f"bridge: expected (B, H, W, {CIN}) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, H, W, _ = x.shape
    ho, wo = H // 2, W // 2
    if H % 2 or W % 2 or ho % TILE or wo % TILE \
            or (ho // TILE) * (wo // TILE) % 2:
        raise ValueError(f"bridge: input {H}x{W} must be even with an "
                         f"output {ho}x{wo} of 8x8 tiles, an even count of "
                         f"them per image")
    _check_weights(weights, x.device)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("bridge: x must be 16-byte aligned")
    out = torch.empty((B, ho, wo, COUT), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    fn = _build.bind("bridge.cu", "tp_bridge", [_build.PTR] * 6
                     + [_build.INT] * 3 + [_build.PTR])
    _build.check(fn(x.data_ptr(), weight_maps(weights).data_ptr(),
                    b1.data_ptr(), b2.data_ptr(), b3.data_ptr(),
                    out.data_ptr(), B, H, W, _build.stream_of(x)), "bridge")
    bridge.launches += 1
    return out


bridge_op = torch.library.custom_op(
    "tpupose_torch::bridge", bridge_impl, mutates_args=())


@bridge_op.register_fake
def _bridge_fake(x, w1, b1, w2, b2, w3, b3, wds):
    B, H, W, _ = x.shape
    return x.new_empty((B, H // 2, W // 2, COUT))


def bridge(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """(B, H, W, 256) -> (B, H/2, W/2, 512). CPU: plain version; CUDA: one
    launch of the csrc/bridge.cu kernel (bf16; H/2 and W/2 multiples of 8
    with an even count of 8 x 8 tiles per image), on weights folded on
    the card (fold_bridge_weights, which encodes their tensor maps);
    through the op `bridge_op` where a program is traced
    (_build.op_or_body)."""
    if x.device.type == "cuda" and "tmaps" not in weights:
        raise ValueError("bridge: weights must come from fold_bridge_weights "
                         "on the card (bf16), which encodes their tensor maps")
    return _build.op_or_body(bridge_op, bridge_impl)(
        x, *(weights[k] for k in ("w1", "b1", "w2", "b2", "w3", "b3",
                                  "wds")))


bridge.launches = 0
