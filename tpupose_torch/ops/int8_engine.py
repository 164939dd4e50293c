"""The fold and calibration half of the int8 serving engine (counterpart of
tpupose/ops/int8_engine.py): the graph IR, BatchNorm and uint8-normalize
folding, `fold_simple_baseline` over the port's `SimpleBaseline`, and the
float32 calibration forward that records every quantized tensor's max-|x|.

`CudaServingEngine` (ops/cuda_engine.py) builds on this. The XLA-style
`Int8Engine` of the JAX module (`_forward_int8`, `_defer_requant`,
`_assign_store`) and `fold_hrnet_pose` are not ported yet.

Layouts are the torch ones: a conv kernel is (O, I, kh, kw), a deconv
kernel is a `ConvTranspose2d` weight (I, O, kh, kw) for stride 2,
padding 1 (the flax kernel rotated 180 degrees). Folding runs in float32,
as the JAX module's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpupose_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

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
    sum of its inputs [+ relu]). quant=True: the output gets a calibrated
    scale; quant=False leaves it fp32 (the final heatmap conv)."""

    kind: str
    out: str
    inputs: Tuple[str, ...]
    spec: Optional[ConvSpec] = None
    quant: bool = True
    relu: bool = False


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
