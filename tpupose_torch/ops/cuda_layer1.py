"""Fused ResNet-50 layer1 (counterpart of tpupose/ops/pallas_layer1.py).

  - `fold_bottleneck` / `fold_layer1_weights`: conv + BN pairs folded
    into matmul-ready weights (1x1 as (Cin, Cout), 3x3 as (3, 3, Cin,
    Cout) HWIO, bf16) and float32 biases; a block with a downsample gets
    one bias for conv3 + downsample together, the two being summed in
    float32 by the kernel;
  - `bottleneck_reference` / `layer1_reference`: the plain PyTorch
    version (im2col matmuls in float32, intermediates rounded to the
    input dtype where the kernel rounds them);
  - `layer1`: the wrapper of csrc/bottleneck.cu (wgmma products fed by
    TMA, clusters of two blocks sharing each weight tile), which replaces
    pallas_layer1.py `_layer1_kernel` with three launches of one fused
    bottleneck kernel, through the torch.library op
    `tpupose_torch::layer1` (`layer1_op`, weights flattened in
    `flatten_layer1`'s order) where a program is traced, its body
    straight in an eager call (_build.op_or_body). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    `layer1.launches` counts launches.
    `check_tiles` holds a shape to the kernel's 16 x 8 tiles and
    `_smem_bytes` mirrors its shared memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpupose_torch.ops import _build
from tpupose_torch.ops.cuda_stem import fold_bn


@torch.no_grad()
def fold_bottleneck(block, dtype=None) -> dict:
    """A torch Bottleneck in eval mode -> {w1, b1, w2, b2, w3, b3[, wds]}."""
    dtype = dtype or block.conv1.weight.dtype
    w1, b1 = fold_bn(block.conv1, block.bn1)
    w2, b2 = fold_bn(block.conv2, block.bn2)
    w3, b3 = fold_bn(block.conv3, block.bn3)
    out = {"w1": w1[:, :, 0, 0].t(), "w2": w2.permute(2, 3, 1, 0),
           "w3": w3[:, :, 0, 0].t()}
    if block.downsample is not None:
        wd, bd = fold_bn(block.downsample[0], block.downsample[1])
        out["wds"] = wd[:, :, 0, 0].t()
        b3 = b3 + bd
    out = {k: v.contiguous().to(dtype) for k, v in out.items()}
    out.update(b1=b1.float(), b2=b2.float(), b3=b3.float())
    return out


def fold_layer1_weights(backbone, dtype=None) -> list:
    """ResNet-50 layer1 (three bottlenecks) -> list of folded blocks."""
    return [fold_bottleneck(blk, dtype) for blk in backbone.layer1]


def bottleneck_reference(x: torch.Tensor, w: dict, stride: int = 1):
    """Plain version of one folded bottleneck on NHWC x (B, H, W, Cin)."""
    dt = x.dtype
    xf = x.float()
    B, H, W, _ = xf.shape
    h = torch.relu(xf @ w["w1"].float() + w["b1"]).to(dt).float()
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    cols = [hp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]
    w2 = w["w2"].float().reshape(-1, w["w2"].shape[-1])
    h = torch.relu(torch.cat(cols, -1) @ w2 + w["b2"]).to(dt).float()
    o = h @ w["w3"].float() + w["b3"]
    if "wds" in w:
        o = o + xf[:, ::stride, ::stride] @ w["wds"].float()
    else:
        o = o + xf
    return torch.relu(o).to(dt)


def layer1_reference(x: torch.Tensor, weights: list) -> torch.Tensor:
    """Plain version: (B, H, W, 64) -> (B, H, W, 256), x.dtype."""
    for w in weights:
        x = bottleneck_reference(x, w, 1)
    return x


_VARIANTS = {0: (64, 64, 256, 1), 1: (256, 64, 256, 1)}
# csrc/bottleneck.cu: a block's output tile, and its shared memory: the
# activation ring (4 slots of 23 KB), the weight ring (8 x 64 x 128 B), h1
# as three copies of 18 x 8 rows of 128 B, whose place h2 and then the
# staged 16 x 8 x 256 bf16 output take, 24 mbarriers and 1024 bytes of
# alignment slack
TILE_H, TILE_W = 16, 8


def _smem_bytes() -> int:
    h1 = 3 * (TILE_H + 2) * TILE_W * 128
    out = TILE_H * TILE_W * 256 * 2
    return 4 * 23 * 1024 + 8 * 64 * 128 + max(h1, out) + 8 * 2 * (4 + 8) + 1024


def check_tiles(h: int, w: int) -> None:
    """Raise unless an h x w output splits into the kernel's 16 x 8 tiles,
    an even count of them per image (a cluster of two blocks takes a
    pair)."""
    if h % TILE_H or w % TILE_W or (h // TILE_H) * (w // TILE_W) % 2:
        raise ValueError(f"bottleneck: output {h}x{w} must split into "
                         f"{TILE_H}x{TILE_W} tiles, an even count of them "
                         f"per image")


def launch_bottleneck(x: torch.Tensor, w: dict, variant: int) -> torch.Tensor:
    """One launch of the csrc/bottleneck.cu kernel (see its variants)."""
    cin, cm, cout, s = _VARIANTS[variant]
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != cin:
        raise ValueError(f"bottleneck variant {variant}: expected (B, H, W, "
                         f"{cin}) bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, H, W, _ = x.shape
    ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
    check_tiles(ho, wo)
    shapes = {"w1": (cin, cm), "w2": (3, 3, cm, cm), "w3": (cm, cout),
              "b1": (cm,), "b2": (cm,), "b3": (cout,)}
    if variant != 1:
        shapes["wds"] = (cin, cout)
    for k, shp in shapes.items():
        t = w[k]
        want = torch.float32 if k[0] == "b" else torch.bfloat16
        if tuple(t.shape) != shp or t.dtype != want or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"bottleneck variant {variant}: weight {k} must "
                             f"be {shp} {want} contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"bottleneck variant {variant}: weight {k} must "
                             f"be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"bottleneck variant {variant}: x must be 16-byte "
                         f"aligned")
    out = torch.empty((B, ho, wo, cout), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    wds = w.get("wds", w["w3"])          # unread by the identity variant
    fn = _build.bind("bottleneck.cu", "tp_bottleneck", [_build.PTR] * 9
                     + [_build.INT] * 4 + [_build.PTR])
    _build.check(fn(x.data_ptr(), w["w1"].data_ptr(), w["b1"].data_ptr(),
                    w["w2"].data_ptr(), w["b2"].data_ptr(),
                    w["w3"].data_ptr(), w["b3"].data_ptr(), wds.data_ptr(),
                    out.data_ptr(), variant, B, H, W, _build.stream_of(x)),
                 f"bottleneck variant {variant}")
    return out


# the order in which `layer1` hands the three folded blocks to the op:
# each block's tensors under these keys, block 0 with its downsample
LAYER1_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def flatten_layer1(weights: list) -> list:
    """[block0, block1, block2] dicts -> the op's flat tensor list: each
    block's LAYER1_KEYS in order, block 0's followed by its "wds"."""
    flat = []
    for i, w in enumerate(weights):
        flat += [w[k] for k in LAYER1_KEYS] + ([w["wds"]] if i == 0 else [])
    return flat


def unflatten_layer1(flat) -> list:
    """Inverse of flatten_layer1."""
    n = len(LAYER1_KEYS)
    if len(flat) != 3 * n + 1:
        raise ValueError(f"layer1: expected {3 * n + 1} weight tensors "
                         f"(three folded blocks), got {len(flat)}")
    out = [dict(zip(LAYER1_KEYS, flat[:n]), wds=flat[n])]
    for i in range(2):
        out.append(dict(zip(LAYER1_KEYS, flat[n + 1 + i * n:
                                             n + 1 + (i + 1) * n])))
    return out


def layer1_impl(x: torch.Tensor,
                weights: list[torch.Tensor]) -> torch.Tensor:
    """The body of K2's torch.library op `layer1_op`, the weights flat (flatten_layer1's
    order): a CPU tensor takes the plain version, a CUDA tensor three
    launches of the fused bottleneck kernel or raises;
    `layer1.launches` rises at each launch."""
    blocks = unflatten_layer1(weights)
    if x.device.type == "cpu":
        return layer1_reference(x, blocks)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer1: unsupported device {x.device}")
    for i, w in enumerate(blocks):
        x = launch_bottleneck(x, w, 0 if i == 0 else 1)
        layer1.launches += 1
    return x


layer1_op = torch.library.custom_op(
    "tpupose_torch::layer1", layer1_impl, mutates_args=())


@layer1_op.register_fake
def _layer1_fake(x, weights):
    return x.new_empty((*x.shape[:3], 256))


def layer1(x: torch.Tensor, weights: list) -> torch.Tensor:
    """(B, H, W, 64) -> (B, H, W, 256). CPU: plain version; CUDA: three
    launches of the fused bottleneck kernel (bf16; H a multiple of 16 and W
    of 8, an even count of 16 x 8 tiles per image); through the op
    `layer1_op` where a program is traced (_build.op_or_body)."""
    return _build.op_or_body(layer1_op, layer1_impl)(
        x, flatten_layer1(weights))


layer1.launches = 0
