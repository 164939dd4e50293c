"""The int8 serving engine (counterpart of tpupose/ops/int8_engine.py):
the graph IR, BatchNorm and uint8-normalize folding, `fold_simple_baseline`
over the port's `SimpleBaseline` and `fold_hrnet_pose` over its
`HRNetPose` (multi-branch stages, cross-resolution fuse sums, nearest
upsampling), the float32 calibration forward that records every
quantized tensor's max-|x|, and the int8 engine `Int8Engine` that runs
the folded graph with int8 products.

Two engines build on the fold. `CudaServingEngine` (ops/cuda_engine.py)
runs SimpleBaseline-R50 on the hand-written kernels K1, K5, K6 and K4.
`Int8Engine` is the JAX module's XLA-style engine, for any SimpleBaseline
or HRNet: every conv is an exact int8 x int8 -> int32 product
(`quant.int8_conv2d`, torch._int_mm on an im2col; in JAX these are XLA
convolutions, no Pallas kernel), then one float32 epilogue per conv. Its
storage policy is JAX's: by default (`min_int8_channels = 1 << 30`) every
quantized tensor is stored in bf16, in real units, and quantized to int8
when a conv reads it; `min_int8_channels` stores the wider ones in int8,
requantized in the producer's epilogue. The order of the scale products
is JAX's (`ws * (xs / t)`, `b * (1.0 / t)`), so `round()` meets the same
boundaries.

Layouts are the torch ones: a folded conv kernel is (O, I, kh, kw), a
deconv kernel a `ConvTranspose2d` weight (I, O, kh, kw) for stride 2,
padding 1 (the flax kernel rotated 180 degrees); the quantized weights
are (kh, kw, I, O), as JAX's. Folding runs in float32, as the JAX
module's does. The calibration forward runs NCHW, the int8 forward NHWC.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpupose_torch._device import resolve_device
from tpupose_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from tpupose_torch.ops.quant import (QMAX, int8_conv2d,
                                     int8_conv_transpose2d, quantize_weight)

# ---------------------------------------------------------------------------
# graph IR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvSpec:
    """One folded convolution. `name` keys into the folded-weights dict.
    deconv=True runs the kernel as a torch ConvTranspose2d (4x4, stride 2,
    padding 1). relu is applied inside the epilogue."""

    name: str
    strides: Tuple[int, int] = (1, 1)
    padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))
    relu: bool = True
    deconv: bool = False


@dataclass(frozen=True)
class Node:
    """One graph op: conv (inputs=(x,)), maxpool (3x3/2 pad 1), add (fp32
    sum of its inputs [+ relu]), upsample (nearest to the size of the
    tensor `like`, or by the integer `factor` without it). quant=True:
    the output gets a calibrated scale and `store` picks how Int8Engine
    keeps it, "int8" (requantized in the producer's epilogue) or "bf16"
    (real units, quantized on read by the consuming conv); quant=False
    leaves it fp32 (the final heatmap conv)."""

    kind: str
    out: str
    inputs: Tuple[str, ...]
    spec: Optional[ConvSpec] = None
    quant: bool = True
    store: str = "int8"
    relu: bool = False
    factor: Tuple[int, int] = (1, 1)
    like: Optional[str] = None


class GraphBuilder:
    """Emit Nodes in topological order; returns tensor ids."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.weights: Dict[str, tuple] = {}
        self._n = 0

    def _fresh(self) -> str:
        self._n += 1
        return f"t{self._n}"

    def conv(self, x: str, name: str, kernel, bias, *, strides=(1, 1),
             padding=((0, 0), (0, 0)), relu=True, deconv=False,
             quant=True) -> str:
        self.weights[name] = (kernel, bias)
        out = self._fresh()
        self.nodes.append(Node("conv", out, (x,),
                               ConvSpec(name, tuple(strides), padding,
                                        relu, deconv), quant=quant))
        return out

    def add(self, xs: Sequence[str], relu=True) -> str:
        out = self._fresh()
        self.nodes.append(Node("add", out, tuple(xs), relu=relu))
        return out

    def maxpool(self, x: str) -> str:
        out = self._fresh()
        self.nodes.append(Node("maxpool", out, (x,)))
        return out

    def upsample(self, x: str, factor: Tuple[int, int],
                 like: Optional[str] = None) -> str:
        out = self._fresh()
        self.nodes.append(Node("upsample", out, (x,), factor=factor,
                               like=like))
        return out


# ---------------------------------------------------------------------------
# folding
# ---------------------------------------------------------------------------


@torch.no_grad()
def _fold_bn(weight, bn, out_dim: int = 0):
    """conv weight + eval-mode BatchNorm -> (folded weight, bias (O,)),
    float32 CPU tensors computed in float32. out_dim: the weight's
    output-channel axis (0 for Conv2d, 1 for ConvTranspose2d)."""
    g, b, mu, var, w = (t.detach().float().cpu() for t in (
        bn.weight, bn.bias, bn.running_mean, bn.running_var, weight))
    f = g / torch.sqrt(var + bn.eps)
    shape = [1] * w.dim()
    shape[out_dim] = -1
    return w * f.reshape(shape), b - mu * f


@torch.no_grad()
def _fold_input_normalize(kernel, bias, mean, std):
    """Fold the uint8 ImageNet normalize into the first conv (O, I, kh, kw).

    The engine feeds x_i8 = pixel - 128 (exact int8). The normalized
    value is alpha*x_i8 + beta with alpha = 1/(255*std) and beta =
    (128/255 - mean)/std; alpha scales the kernel's input channels and
    the beta term (constant across pixels, because the padding uses the
    beta-zero pixel) folds into the bias. Returns (kernel, bias, pad) with
    pad the per-channel int8 pixel that normalizes to 0."""
    m = torch.tensor(mean, dtype=torch.float32)
    s = torch.tensor(std, dtype=torch.float32)
    alpha = 1.0 / (255.0 * s)
    beta = (128.0 / 255.0 - m) / s
    k_in = kernel * alpha[None, :, None, None]
    b_in = bias + torch.einsum("oihw,i->o", kernel, beta)
    pad = torch.clamp(torch.round(
        255.0 * torch.tensor(mean, dtype=torch.float64) - 128.0),
        -128, 127).to(torch.int8)
    return k_in, b_in, pad


def _is_basic(block) -> bool:
    """BasicBlock has no conv3."""
    return not hasattr(block, "conv3")


def _emit_residual_block(g: GraphBuilder, x: str, block, base: str,
                         stride: int) -> str:
    """A port BasicBlock / Bottleneck (torchvision names) -> graph nodes,
    named as the JAX module names them ({base}/c0.., {base}/proj)."""
    s = (stride, stride)
    if _is_basic(block):
        y = g.conv(x, f"{base}/c0", *_fold_bn(block.conv1.weight, block.bn1),
                   strides=s, padding=((1, 1), (1, 1)))
        y = g.conv(y, f"{base}/c1", *_fold_bn(block.conv2.weight, block.bn2),
                   padding=((1, 1), (1, 1)), relu=False)
    else:
        y = g.conv(x, f"{base}/c0", *_fold_bn(block.conv1.weight, block.bn1))
        y = g.conv(y, f"{base}/c1", *_fold_bn(block.conv2.weight, block.bn2),
                   strides=s, padding=((1, 1), (1, 1)))
        y = g.conv(y, f"{base}/c2", *_fold_bn(block.conv3.weight, block.bn3),
                   relu=False)
    res = x
    if block.downsample is not None:
        res = g.conv(x, f"{base}/proj",
                     *_fold_bn(block.downsample[0].weight,
                               block.downsample[1]),
                     strides=s, relu=False)
    return g.add((y, res), relu=True)


@torch.no_grad()
def fold_simple_baseline(model, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The port's SimpleBaseline (ResNet + deconv head) -> (nodes, weights,
    stem_pad, in_pad). The first conv eats raw `pixel - 128` int8 input;
    in_pad is its spatial padding, applied on the int8 canvas with the
    stem_pad (normalized-zero) pixel value. Weights are float32 CPU
    tensors whatever the model's dtype and device."""
    bb = model.backbone
    g = GraphBuilder()

    k, b = _fold_bn(bb.conv1.weight, bb.bn1)
    k, b, stem_pad = _fold_input_normalize(k, b, mean, std)
    x = g.conv("in", "stem", k, b, strides=(2, 2))
    x = g.maxpool(x)

    prefix = bb.block_cls.__name__
    n = 0
    for i in range(len(bb.stage_sizes)):
        for j, blk in enumerate(getattr(bb, f"layer{i + 1}")):
            stride = 2 if (i > 0 and j == 0) else 1
            x = _emit_residual_block(g, x, blk, f"{prefix}_{n}", stride)
            n += 1

    layers = list(model.head.deconv_layers)
    for i in range(len(layers) // 3):
        k, b = _fold_bn(layers[3 * i].weight, layers[3 * i + 1], out_dim=1)
        x = g.conv(x, f"deconv{i}", k, b, strides=(2, 2), deconv=True)
    fl = model.head.final_layer
    g.conv(x, "final", fl.weight.detach().float().cpu(),
           fl.bias.detach().float().cpu(), relu=False, quant=False)
    return g.nodes, g.weights, stem_pad, (3, 3)


@torch.no_grad()
def fold_hrnet_pose(model, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The port's HRNetPose -> (nodes, weights, stem_pad, in_pad), in the
    JAX module's node order and names: the stem (uint8 normalize folded
    into its first conv), stem1, Bottleneck_0..3, the transitions
    tr0a/tr0b, tr1, tr2, each stage module's branches
    s{k}m{m}b{i}/BasicBlock_{b} and fuse convs s{k}m{m}f{i}{j}[k{step}]
    with an upsample to the target branch's size, the float32 head
    `final`."""
    bb = model.backbone
    g = GraphBuilder()

    def convbn(x, m, name):
        k, b = _fold_bn(m.conv.weight, m.bn)
        p = k.shape[2] // 2
        return g.conv(x, name, k, b, strides=tuple(m.conv.stride),
                      padding=((p, p), (p, p)), relu=m.relu)

    s0 = bb.stem[0]
    k, b = _fold_bn(s0.conv.weight, s0.bn)
    k, b, stem_pad = _fold_input_normalize(k, b, mean, std)
    x = g.conv("in", "stem", k, b, strides=(2, 2))
    x = convbn(x, bb.stem[1], "stem1")
    for n, blk in enumerate(bb.layer1):
        x = _emit_residual_block(g, x, blk, f"Bottleneck_{n}", 1)

    def run_stage(xs, stage, k):
        n = len(xs)
        for m, (branches, fuse) in enumerate(zip(stage.branches,
                                                 stage.fuse)):
            ys = []
            for i, y in enumerate(xs):
                for b, blk in enumerate(branches[i].blocks):
                    y = _emit_residual_block(
                        g, y, blk, f"s{k}m{m}b{i}/BasicBlock_{b}", 1)
                ys.append(y)
            outs = []
            for i in range(n):
                terms = []
                for j in range(n):
                    y = ys[j]
                    if j > i:
                        y = convbn(y, fuse.paths[f"{i}_{j}"],
                                   f"s{k}m{m}f{i}{j}")
                        f = 2 ** (j - i)
                        y = g.upsample(y, (f, f), like=ys[i])
                    elif j < i:
                        for step, cb in enumerate(fuse.paths[f"{i}_{j}"]):
                            y = convbn(y, cb, f"s{k}m{m}f{i}{j}k{step}")
                    terms.append(y)
                outs.append(g.add(terms, relu=True))
            xs = outs
        return xs

    b0 = convbn(x, bb.transition1[0], "tr0a")
    b1 = convbn(x, bb.transition1[1], "tr0b")
    xs = run_stage([b0, b1], bb.stage2, 0)
    xs = run_stage(xs + [convbn(xs[-1], bb.transition2, "tr1")],
                   bb.stage3, 1)
    xs = run_stage(xs + [convbn(xs[-1], bb.transition3, "tr2")],
                   bb.stage4, 2)
    fl = model.final_layer
    g.conv(xs[0], "final", fl.weight.detach().float().cpu(),
           fl.bias.detach().float().cpu(), relu=False, quant=False)
    return g.nodes, g.weights, stem_pad, (1, 1)


def _fold(model):
    name = getattr(model, "backbone_name", "") or ""
    if name.startswith("hrnet"):
        return fold_hrnet_pose(model)
    if name.startswith("resnet"):
        return fold_simple_baseline(model)
    raise ValueError(
        f"Int8Engine supports the SimpleBaseline (resnet*) and HRNet "
        f"(hrnet*) heatmap families only, got {type(model).__name__} with "
        f"backbone={name!r}")


# ---------------------------------------------------------------------------
# calibration forward
# ---------------------------------------------------------------------------


def _stem_int8(images: torch.Tensor, stem_pad, in_pad) -> torch.Tensor:
    """uint8 NHWC -> zero-error int8 with normalized-zero border padding.
    Float pixel inputs (still in [0, 255]) are rounded, not truncated."""
    if images.is_floating_point():
        images = torch.round(images)
    x = (images.to(torch.int32) - 128).to(torch.int8)
    B, H, W, C = x.shape
    ph, pw = in_pad
    canvas = torch.empty((B, H + 2 * ph, W + 2 * pw, C), dtype=torch.int8,
                         device=x.device)
    canvas[:] = torch.as_tensor(stem_pad, dtype=torch.int8, device=x.device)
    canvas[:, ph:ph + H, pw:pw + W] = x
    return canvas


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """The source index of each of n_out pixels under JAX's nearest
    resize: floor((d + 0.5) * n_in / n_out), taken from torch's
    "nearest-exact" itself so the gather and the float path agree."""
    src = torch.arange(n_in, dtype=torch.float32).view(1, 1, n_in)
    idx = F.interpolate(src, size=n_out, mode="nearest-exact")
    return idx.view(-1).long().to(device)


def _upsample_nearest(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Nearest upsample of NHWC `x` (any dtype, int8 included) to
    `target_hw` by an index gather: the model's _upsample_to at every
    ratio, integer or not."""
    th, tw = target_hw
    ih = _nearest_index(x.shape[1], th, x.device)
    iw = _nearest_index(x.shape[2], tw, x.device)
    return x.index_select(1, ih).index_select(2, iw)


def _upsample_target(nd: Node, hw, env_hw):
    """The upsample's output size: that of the tensor `like` where the
    node names one (`env_hw(name)`), else `hw` times `factor`."""
    if nd.like is not None:
        return tuple(env_hw(nd.like))
    return (hw[0] * nd.factor[0], hw[1] * nd.factor[1])


def _maxpool(x: torch.Tensor, pad_value) -> torch.Tensor:
    """3x3/2 max pool, padding 1 filled with `pad_value`, over NHWC `x` of
    any dtype (int8 included: the max of int8 codes is the int8 code of
    the max, the scale being positive)."""
    B, H, W, C = x.shape
    xp = torch.full((B, H + 2, W + 2, C), pad_value, dtype=x.dtype,
                    device=x.device)
    xp[:, 1:H + 1, 1:W + 1] = x
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            v = xp[:, dy:dy + 2 * Ho - 1:2, dx:dx + 2 * Wo - 1:2]
            out = v if out is None else torch.maximum(out, v)
    return out


def _conv_any(x, kernel, bias, spec: ConvSpec):
    """float32 NCHW conv (or ConvTranspose2d 4x4/2 pad 1) + bias."""
    if spec.deconv:
        y = F.conv_transpose2d(x, kernel, stride=spec.strides, padding=1)
    else:
        (pt, pb), (pl, pr) = spec.padding
        if (pt, pl) != (pb, pr):
            raise ValueError(f"asymmetric padding {spec.padding}")
        y = F.conv2d(x, kernel, stride=spec.strides, padding=(pt, pl))
    return y + bias[None, :, None, None]


@torch.no_grad()
def _forward_calib(nodes, weights, stem_pad, in_pad, images):
    """fp32 folded forward from uint8 (mirrors the int8 dataflow, including
    the exact-integer input representation), with TF32 off. Returns
    (final fp32 tensor NHWC, amax list in graph order as 0-d tensors).
    Runs on `images`' device; the weights are moved there."""
    dev = images.device
    env = {"in": _stem_int8(images, stem_pad, in_pad).float()
           .permute(0, 3, 1, 2)}
    amax: List[torch.Tensor] = []
    last = None
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for nd in nodes:
            if nd.kind == "conv":
                k, b = weights[nd.spec.name]
                y = _conv_any(env[nd.inputs[0]], k.to(dev), b.to(dev),
                              nd.spec)
                if nd.spec.relu:
                    y = torch.relu(y)
            elif nd.kind == "maxpool":
                y = F.max_pool2d(env[nd.inputs[0]], 3, 2, 1)
            elif nd.kind == "upsample":
                x = env[nd.inputs[0]]
                y = F.interpolate(x, size=_upsample_target(
                    nd, x.shape[2:], lambda n: env[n].shape[2:]),
                    mode="nearest-exact")
            elif nd.kind == "add":
                y = env[nd.inputs[0]]
                for nm in nd.inputs[1:]:
                    y = y + env[nm]
                if nd.relu:
                    y = torch.relu(y)
            else:
                raise ValueError(nd.kind)
            if nd.quant and nd.kind in ("conv", "add"):
                amax.append(y.abs().max())
            env[nd.out] = y
            last = y
    return last.permute(0, 2, 3, 1), amax


# ---------------------------------------------------------------------------
# graph passes
# ---------------------------------------------------------------------------


def _defer_requant(nodes):
    """Graph pass: a quantized conv whose output feeds exactly one
    quantized `add` keeps its float32 accumulator, pre-scaled into the
    add's output units ("f32t"), instead of a requant. In JAX this was
    measured slower (XLA did not fuse the conv with the add) and is off
    by default; `Int8Engine.build(defer_requant=True)` turns it on."""
    consumers: Dict[str, List[Node]] = {}
    for nd in nodes:
        for nm in nd.inputs:
            consumers.setdefault(nm, []).append(nd)
    out = []
    for nd in nodes:
        cs = consumers.get(nd.out, [])
        if (nd.kind == "conv" and nd.quant and len(cs) == 1
                and cs[0].kind == "add" and cs[0].quant):
            nd = dataclasses.replace(nd, quant=False)
        out.append(nd)
    return out


def _scale_map(nodes, scales):
    """Calibrated steps (amax / QMAX) of the quantized node outputs, in
    the graph order _forward_calib records them; and, for each
    unquantized conv that feeds a quantized add (the _defer_requant
    pattern), the add's step its epilogue pre-folds."""
    tmap: Dict[str, float] = {}
    it = iter([float(s) / QMAX for s in scales])
    for nd in nodes:
        if nd.quant and nd.kind in ("conv", "add"):
            tmap[nd.out] = next(it)
    deferred: Dict[str, float] = {}
    for nd in nodes:
        if nd.kind == "add" and nd.quant:
            for nm in nd.inputs:
                if nm not in tmap and nm != "in":
                    src = next((s for s in nodes if s.out == nm), None)
                    if src is not None and src.kind == "conv" \
                            and not src.quant:
                        deferred[nm] = tmap[nd.out]
    return tmap, deferred


def _out_channels(nd: Node, weights) -> int:
    k, _ = weights[nd.spec.name]
    return int(k.shape[1] if nd.spec.deconv else k.shape[0])


def _assign_store(nodes, weights, min_int8_channels: int = 128):
    """Storage pass: quantized tensors narrower than `min_int8_channels`
    are stored in bf16 instead of int8 (min 0: every one in int8)."""
    ch = {"in": 3}
    out = []
    for nd in nodes:
        c = (_out_channels(nd, weights) if nd.kind == "conv"
             else ch[nd.inputs[0]])
        ch[nd.out] = c
        if (nd.quant and nd.kind in ("conv", "add")
                and c < min_int8_channels):
            nd = dataclasses.replace(nd, store="bf16")
        out.append(nd)
    return out


def _quantize_weights(nodes, weights):
    """{conv name: (int8 (kh, kw, I, O) kernel, per-O step ws / QMAX,
    float32 bias)}, the recipe of quant.quantize_weight."""
    out = {}
    for nd in nodes:
        if nd.kind != "conv":
            continue
        k, b = weights[nd.spec.name]
        hwio = k.permute(2, 3, 0, 1) if nd.spec.deconv \
            else k.permute(2, 3, 1, 0)
        wq, ws = quantize_weight(hwio)
        out[nd.spec.name] = (wq.contiguous(), ws / QMAX, b.float())
    return out


# ---------------------------------------------------------------------------
# the int8 forward
# ---------------------------------------------------------------------------


def _conv_int8(xq, wq, spec: ConvSpec):
    """int8 NHWC input and (kh, kw, I, O) kernel -> exact int32 NHWC."""
    if spec.deconv:
        return int8_conv_transpose2d(xq, wq, spec.strides, (1, 1))
    return int8_conv2d(xq, wq, spec.strides, spec.padding)


def _forward_int8(nodes, qweights, scales, stem_pad, in_pad, images):
    """The mixed-precision pass over the graph: uint8 NHWC -> float32
    heatmaps NHWC. env holds (tensor, scale, mode) triples:

      "i8"   int8 storage, value = q * scale;
      "bf16" bf16 storage in real units; `scale` is the calibrated step
             a consuming conv quantizes it with (requant on read);
      "f32t" float32 in `scale` units (the _defer_requant branch);
      "f32"  float32 real units, scale None (the heatmaps).

    An int8-store epilogue is one multiply-add per element, the requant
    1/t merged into the per-channel weight scale and the bias, ReLU
    folded into the clip's lower bound."""
    env = {"in": (_stem_int8(images, stem_pad, in_pad), 1.0, "i8")}
    tmap, deferred = _scale_map(nodes, scales)

    def as_int8_operand(nm):
        q, s, mode = env[nm]
        if mode == "i8":
            return q, s
        if mode != "bf16":
            raise ValueError(f"conv input must be i8/bf16, got {mode}")
        xq = torch.clamp(torch.round(q.float() * (1.0 / s)), -QMAX, QMAX)
        return xq.to(torch.int8), s

    last = None
    for nd in nodes:
        if nd.kind == "conv":
            xq, xs = as_int8_operand(nd.inputs[0])
            wq, ws, b = qweights[nd.spec.name]
            acc = _conv_int8(xq, wq, nd.spec).float()
            if nd.quant and nd.store == "int8":
                t = tmap[nd.out]
                y = acc * (ws * (xs / t)) + b * (1.0 / t)
                lo = 0.0 if nd.spec.relu else -QMAX
                yq = torch.clamp(torch.round(y), lo, QMAX).to(torch.int8)
                env[nd.out] = (yq, t, "i8")
            elif nd.quant:
                y = acc * (ws * xs) + b
                if nd.spec.relu:
                    y = torch.relu(y)
                env[nd.out] = (y.to(torch.bfloat16), tmap[nd.out], "bf16")
            elif nd.out in deferred:
                t = deferred[nd.out]
                y = acc * (ws * (xs / t)) + b * (1.0 / t)
                if nd.spec.relu:
                    y = torch.relu(y)
                env[nd.out] = (y, t, "f32t")
            else:
                y = acc * (ws * xs) + b
                if nd.spec.relu:
                    y = torch.relu(y)
                env[nd.out] = (y, None, "f32")
        elif nd.kind == "maxpool":
            xq, xs, mode = env[nd.inputs[0]]
            pad = -128 if mode == "i8" else float("-inf")
            env[nd.out] = (_maxpool(xq, pad), xs, mode)
        elif nd.kind == "upsample":
            xq, xs, mode = env[nd.inputs[0]]
            thw = _upsample_target(nd, xq.shape[1:3],
                                   lambda n: env[n][0].shape[1:3])
            env[nd.out] = (_upsample_nearest(xq, thw), xs, mode)
        elif nd.kind == "add":
            t = tmap[nd.out] if nd.quant else None
            int8_out = nd.quant and nd.store == "int8"
            modes = [env[nm][2] for nm in nd.inputs]
            # fold each input's s/t into its dequant only when the result
            # is requantized and no input is in real units already
            fold = int8_out and all(m in ("i8", "f32t") for m in modes)
            y = None
            for nm in nd.inputs:
                q, s, mode = env[nm]
                if mode == "bf16":
                    v = q.float()
                elif mode == "f32t":
                    v = q if (fold and s == t) else q * (s if not fold
                                                         else s / t)
                else:
                    v = q.float() * (s / t if fold else s)
                y = v if y is None else y + v
            if int8_out:
                if not fold:
                    y = y * (1.0 / t)
                lo = 0.0 if nd.relu else -QMAX
                env[nd.out] = (torch.clamp(torch.round(y), lo, QMAX)
                               .to(torch.int8), t, "i8")
            elif nd.quant:
                if nd.relu:
                    y = torch.relu(y)
                env[nd.out] = (y.to(torch.bfloat16), t, "bf16")
            else:
                if nd.relu:
                    y = torch.relu(y)
                env[nd.out] = (y, None, "f32")
        else:
            raise ValueError(nd.kind)
        last = env[nd.out]
    return last[0]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class Int8Engine:
    """Built once from a SimpleBaseline or HRNetPose and representative
    uint8 crop batches; called with uint8 NHWC crops, it returns float32
    heatmaps NHWC on its device. `decode()` adds the DARK decode (the
    K4 kernel on the card).

    >>> eng = Int8Engine.build(model, calib=[crops], device="cuda")
    >>> hm = eng(crops)                       # (B, Hh, Wh, K) float32
    >>> coords, scores = eng.decode(crops)

    Runs on `device` (default "cuda"; raises where CUDA is absent). JAX's
    `weights_as_args` (XLA constants or runtime buffers) has no meaning
    here: the weights are tensors on the device either way."""

    def __init__(self, nodes, qweights, scales, stem_pad, in_pad,
                 decode_method: str = "dark", blur_kernel: int = 11,
                 sigma: float = 2.0, device="cuda"):
        self.device = resolve_device(device)
        self._nodes = nodes
        self._qw = {k: tuple(t.to(self.device) for t in v)
                    for k, v in qweights.items()}
        self._scales = tuple(scales)
        self._pad = stem_pad
        self._in_pad = in_pad
        self.decode_method = decode_method
        self.blur_kernel = blur_kernel
        self.sigma = sigma

    @classmethod
    def build(cls, model, calib: Sequence = (), decode_method: str = "dark",
              blur_kernel: int = 11, sigma: float = 2.0,
              defer_requant: bool = False,
              min_int8_channels: int = 1 << 30, device="cuda"):
        """Fold `model` (its current weights, read in float32), calibrate
        every quantized tensor's max |x| on `calib` (a uint8 NHWC batch
        or a sequence of them) with the float32 folded graph on `device`,
        and quantize the weights."""
        dev = resolve_device(device)
        nodes, weights, stem_pad, in_pad = _fold(model)
        nodes = _assign_store(nodes, weights, min_int8_channels)
        if defer_requant:
            nodes = _defer_requant(nodes)
        calib = [calib] if hasattr(calib, "shape") else list(calib)
        if not calib:
            raise ValueError("need >=1 uint8 calibration batch")
        wdev = {k: (a.to(dev), b.to(dev)) for k, (a, b) in weights.items()}
        amax = None
        for batch in calib:
            got = torch.stack(_forward_calib(
                nodes, wdev, stem_pad, in_pad,
                torch.as_tensor(batch, device=dev))[1]).double().cpu()
            amax = got if amax is None else torch.maximum(amax, got)
        amax = [max(float(a), 1e-6) for a in amax]
        return cls(nodes, _quantize_weights(nodes, weights), amax, stem_pad,
                   in_pad, decode_method, blur_kernel, sigma, device=dev)

    @torch.no_grad()
    def forward_traceable(self, images):
        """The int8 forward, uint8 NHWC -> float32 heatmaps NHWC."""
        images = torch.as_tensor(images, device=self.device)
        return _forward_int8(self._nodes, self._qw, self._scales, self._pad,
                             self._in_pad, images)

    __call__ = forward = forward_traceable

    @torch.no_grad()
    def decode(self, images):
        """uint8 crops -> (coords (B, K, 2) in heatmap px, scores (B, K))."""
        from tpupose_torch.ops.decode import decode_heatmaps

        hm = self(images).permute(0, 3, 1, 2)
        return decode_heatmaps(hm, self.decode_method, self.blur_kernel,
                               self.sigma)


def folded_fp32_forward(model):
    """The BN-folded float32 graph of `model` as fn(uint8 NHWC) ->
    heatmaps NHWC, on the images' device (pins the fold against the
    model's own forward)."""
    nodes, weights, stem_pad, in_pad = _fold(model)

    def fn(images):
        images = torch.as_tensor(images)
        return _forward_calib(nodes, weights, stem_pad, in_pad, images)[0]

    return fn


def build_int8_engine(model, calib, decode_method: str = "dark",
                      blur_kernel: int = 11, device="cuda"):
    """The engine of eval.int8_engine for `model`, one rule for cli.serve
    and Trainer.evaluate, so that what is evaluated is what is served:
    SimpleBaseline-R50 on the hand-written int8 kernels
    (ops/cuda_engine.CudaServingEngine, K5/K6), any other SimpleBaseline
    or HRNet on Int8Engine. Calibrated on `calib` (uint8 NHWC)."""
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    if (isinstance(model, SimpleBaseline)
            and model.backbone_name == "resnet50"):
        from tpupose_torch.ops.cuda_engine import CudaServingEngine

        return CudaServingEngine.build(model, calib, device=device)
    return Int8Engine.build(model, calib=calib, decode_method=decode_method,
                            blur_kernel=blur_kernel, device=device)
