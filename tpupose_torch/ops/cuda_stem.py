"""Fused ResNet stem (conv 7x7/2 + BN + ReLU + max-pool 3x3/2) and the
composed R50 serving forward (counterpart of tpupose/ops/pallas_stem.py).

  - `fold_stem_weights`: BatchNorm (and optionally the uint8 normalize's
    per-channel scale) folded into the stem conv (HWIO bf16 weights +
    float32 bias), computed in float64;
  - `center_raw`: raw uint8 pixels minus 255*mean, the input that goes
    with `fold_stem_weights(input_scale=1/(255*std))`;
  - `stem_pool_reference`: the plain PyTorch version, in float32 with
    the conv output rounded to the input dtype before the pool, as the
    kernel rounds it;
  - `stem_pool`: the wrapper of the hand-written kernel in
    csrc/stem.cu (wgmma products per conv row, the pool in registers, a
    producer warp feeding a ring of input rows), which replaces
    pallas_stem.py `_stem_kernel`, through the torch.library op
    `tpupose_torch::stem_pool` (`stem_pool_op`) where a program is
    traced, its body straight in an eager call (_build.op_or_body). A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. `stem_pool.launches` counts launches; `stem_tile` is the kernel's chooser of its wgmma N
    and work units, `_smem_bytes` mirrors its shared memory;
  - `is_fast_r50` / `fold_fast_r50`: which models the composed forward
    covers (a SimpleBaseline-R50 computing in bf16, float32 masters or
    not) and its folded weights, in the compute dtype;
  - `fast_r50_stem_apply`: stem + layer1 + block2_0 kernels, then the
    rest of the model, as pallas_stem.py `fast_r50_stem_apply` with
    `scales=None, bridge=True`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpupose_torch.ops import _build
from tpupose_torch.ops.preprocess import IMAGENET_MEAN


@torch.no_grad()
def fold_bn(conv: torch.nn.Module, bn: torch.nn.BatchNorm2d):
    """Conv weight (O, I, kh, kw) and eval-mode BN -> (weight * f, bias)
    in float64, f = gamma / sqrt(var + eps)."""
    f = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
    return (conv.weight.double() * f[:, None, None, None],
            bn.bias.double() - bn.running_mean.double() * f)


@torch.no_grad()
def fold_stem_weights(backbone, dtype=None, input_scale=None) -> dict:
    """The backbone's conv1 + bn1 -> {"w": (7, 7, 3, 64) HWIO in `dtype`
    (default: the conv's dtype), "bias": (64,) float32}.

    input_scale (per input channel, len 3), e.g. 1/(255*std_c) for the
    uint8 normalize with the mean taken off by `center_raw`, is folded
    into the weights in float64. Only a scale may be folded: it commutes
    with the conv's zero padding, a shift would not."""
    dtype = dtype or backbone.conv1.weight.dtype
    w, b = fold_bn(backbone.conv1, backbone.bn1)
    if input_scale is not None:
        sc = torch.as_tensor(input_scale, dtype=torch.float64,
                             device=w.device)
        w = w * sc.reshape(1, 3, 1, 1)
    return {"w": w.permute(2, 3, 1, 0).contiguous().to(dtype),
            "bias": b.float()}


def center_raw(images: torch.Tensor, mean=IMAGENET_MEAN) -> torch.Tensor:
    """Per-channel centering of raw uint8 pixels: x - 255*mean_c, float32.
    With fold_stem_weights(input_scale=1/(255*std)) this is the ImageNet
    normalize, exact at the conv's zero-padded border too (centered 0 ==
    normalized 0)."""
    m = torch.tensor(mean, dtype=torch.float32, device=images.device) * 255.0
    return images.to(torch.float32) - m


def stem_pool_reference(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """Plain version: normalized (B, H, W, 3) -> pooled (B, Hp, Wp, 64),
    x.dtype, NHWC."""
    xf = x.float().permute(0, 3, 1, 2)
    wf = weights["w"].float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, weights["bias"], stride=2, padding=3)
    y = torch.relu(y).to(x.dtype).float()
    y = F.max_pool2d(y, 3, 2, 1)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


# csrc/stem.cu: the wgmma's N (conv columns a product covers), pooled rows
# per strip, input rows in the ring and raw rows in flight
STEM_NT = (104, 152)
STRIP_ROWS, RING_ROWS, RAW_ROWS = 16, 12, 4


def _pooled(n: int) -> int:
    """The stem's output size along an input side of n: conv /2, pool /2."""
    return (n - 1) // 4 + 1


def stem_tile(h: int, w: int):
    """The kernel's tiling of an (h, w) input: (nt, chunks, strips). nt is
    the wgmma's N, 104 where one chunk of (nt - 1) // 2 = 51 pooled columns
    covers the pooled width, else 152 (75 pooled columns a chunk, as many
    chunks as the width needs); strips of 16 pooled rows."""
    hp, wp = _pooled(h), _pooled(w)
    nt = STEM_NT[0] if wp <= (STEM_NT[0] - 1) // 2 else STEM_NT[1]
    pc = (nt - 1) // 2
    return nt, -(-wp // pc), -(-hp // STRIP_ROWS)


def _smem_bytes(nt: int) -> int:
    """Dynamic shared memory of the kernel for wgmma N = nt: the ring of
    input rows (2 nt + 6 pixels of 8 bytes), the raw rows, two staged
    pooled rows, the mbarriers and 128 bytes of alignment slack."""
    spx = 2 * nt + 6
    raw = (spx * 6 + 30) // 16 * 16
    return (RING_ROWS * spx * 8 + RAW_ROWS * raw
            + 2 * ((nt - 1) // 2) * 128 + 2 * RING_ROWS * 8 + 128)


def stem_pool_impl(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """The body of K1's torch.library op `stem_pool_op` (what an exported
    program records): a CPU
    tensor takes the plain version, a CUDA tensor the csrc/stem.cu kernel
    (bf16 only) or raises. `stem_pool.launches` rises here, at each
    launch, not where a program is traced."""
    if x.device.type == "cpu":
        return stem_pool_reference(x, {"w": w, "bias": bias})
    if x.device.type != "cuda":
        raise RuntimeError(f"stem_pool: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem_pool: expected (B, H, W, 3) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w.dtype != torch.bfloat16 or tuple(w.shape) != (7, 7, 3, 64) \
            or bias.dtype != torch.float32 or w.device != x.device:
        raise ValueError("stem_pool: weights must come from "
                         "fold_stem_weights(..., dtype=bfloat16) on x's device")
    x = x.contiguous()
    if x.data_ptr() % 16:                # the kernel's 16-byte row copies
        x = x.clone()
    B, H, W, _ = x.shape
    out = torch.empty((B, _pooled(H), _pooled(W), 64), dtype=x.dtype,
                      device=x.device)
    if B == 0:
        return out
    nt, _, _ = stem_tile(H, W)
    fn = _build.bind("stem.cu", "tp_stem_pool", [_build.PTR] * 4
                     + [_build.INT] * 4 + [_build.PTR])
    _build.check(fn(x.data_ptr(), w.contiguous().data_ptr(),
                    bias.contiguous().data_ptr(), out.data_ptr(), B, H, W,
                    nt, _build.stream_of(x)), "stem_pool")
    stem_pool.launches += 1
    return out


stem_pool_op = torch.library.custom_op(
    "tpupose_torch::stem_pool", stem_pool_impl, mutates_args=())


@stem_pool_op.register_fake
def _stem_pool_fake(x, w, bias):
    return x.new_empty((x.shape[0], _pooled(x.shape[1]), _pooled(x.shape[2]),
                        64))


def stem_pool(x: torch.Tensor, weights: dict) -> torch.Tensor:
    """(B, H, W, 3) -> (B, Hp, Wp, 64). CPU: plain version; CUDA: the
    csrc/stem.cu kernel (bf16 only); through the op `stem_pool_op` where
    a program is traced (_build.op_or_body)."""
    return _build.op_or_body(stem_pool_op, stem_pool_impl)(
        x, weights["w"], weights["bias"])


stem_pool.launches = 0


def compute_dtype(model) -> torch.dtype:
    """The dtype a model computes in: `model.compute_dtype` where it has
    one (a SimpleBaseline with float32 master weights under bf16
    autocast computes in bf16), else its parameters' dtype."""
    return getattr(model, "compute_dtype", next(model.parameters()).dtype)


def is_fast_r50(model) -> bool:
    """True where the fused serving forward covers the model: a
    SimpleBaseline with a ResNet-50 backbone that computes in bf16 (the
    kernels' type), whatever its parameters' dtype, or any model of that
    kind on the CPU (where the plain versions run in any dtype). The
    other families on a ResNet-50 (SimCC, DeepPose, bottom-up) have
    other heads and take their own forward."""
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    p = next(model.parameters())
    return (isinstance(model, SimpleBaseline)
            and model.backbone_name == "resnet50"
            and (compute_dtype(model) == torch.bfloat16
                 or p.device.type == "cpu"))


@torch.no_grad()
def fold_fast_r50(model) -> dict:
    """Fold every weight the fused forward's kernels take, once, in the
    model's compute dtype (from float32 masters where it keeps them)."""
    from tpupose_torch.ops.cuda_bridge import fold_bridge_weights
    from tpupose_torch.ops.cuda_layer1 import fold_layer1_weights

    bb, dt = model.backbone, compute_dtype(model)
    return {"stem": fold_stem_weights(bb, dt),
            "layer1": fold_layer1_weights(bb, dt),
            "bridge": fold_bridge_weights(bb, dt)}


@torch.no_grad()
def fast_r50_stem_apply(model, x: torch.Tensor, weights: dict):
    """The composed serving forward of SimpleBaseline-R50: normalized NHWC
    (B, H, W, 3) in the folded weights' dtype -> heatmaps (B, H/4, W/4,
    K).

    Fused stem+pool kernel (replaces conv1, bn1 and the max-pool), layer1
    kernel (layer1 blocks 0-2), block2_0 kernel (layer2 block 0), then
    the model's own modules for layer2 blocks 1-3, layer3, layer4 and the
    head, under the torch.autocast that the model's own forward uses when
    its compute and parameter dtypes differ. `weights` from
    fold_fast_r50(model)."""
    from tpupose_torch.ops.cuda_bridge import bridge
    from tpupose_torch.ops.cuda_layer1 import layer1

    bb = model.backbone
    y = stem_pool(x, weights["stem"])
    y = layer1(y, weights["layer1"])
    y = bridge(y, weights["bridge"])
    y = y.permute(0, 3, 1, 2)                   # NCHW view, channels_last
    dt = compute_dtype(model)
    with torch.autocast(y.device.type, dtype=dt,
                        enabled=dt != next(model.parameters()).dtype):
        for blk in list(bb.layer2)[1:]:
            y = blk(y)
        y = model.head(bb.layer4(bb.layer3(y)))
    return y.permute(0, 2, 3, 1)
