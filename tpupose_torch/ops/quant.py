"""Post-training int8 quantization (PTQ) of the inference path
(counterpart of tpupose/ops/quant.py).

- `quantize_weight`: per-output-channel symmetric int8 (max-abs);
  `quantize_activation`: per-tensor symmetric int8 with a calibrated
  scale.
- `calibrate(model, batches)`: the max |input| of every quantizable
  `nn.Conv2d`, `nn.ConvTranspose2d` and `nn.Linear`, keyed by its
  `named_modules()` name (the JAX module keys them by flax path; the
  converters' `paths=` give the map between the two).
- `make_quant_interceptor(model, scales)`: a context manager that swaps
  the forward of each calibrated, quantizable module for an int8 one and
  restores it on exit, exceptions included. `quantized_apply` runs the
  model under it. The model's code and parameters stay as they are: the
  weights are quantized inside each call, as in JAX.
- Everything else (BatchNorm, ReLU, adds, pooling, decode) stays in the
  model's float type. Grouped, dilated or non-zero-padded convs keep
  their own forward.

The int8 products are exact int32 sums: `int8_conv2d` runs a conv as
`torch._int_mm` on an im2col of the int8 input, with K (the taps) and N
(the output channels) zero-padded to multiples of 8 and M to more than 16
rows, which `_int_mm` wants on the card. In JAX these are XLA
convolutions with int32 accumulation, reaching no Pallas kernel.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

QMAX = 127.0


def quantize_weight(kernel: torch.Tensor):
    """fp kernel (..., I, O) -> (int8 kernel, per-output-channel float32
    scale (O,)): symmetric max-abs per output channel, in float32, O last
    (the JAX layout, HWIO for a conv, (I, O) for a dense layer)."""
    k = kernel.to(torch.float32)
    dims = tuple(range(k.dim() - 1))
    ws = torch.clamp(k.abs().amax(dim=dims), min=1e-8)
    wq = torch.round(k / ws * QMAX).to(torch.int8)
    return wq, ws


def quantize_activation(x: torch.Tensor, scale: float) -> torch.Tensor:
    """fp activations -> int8 with the calibrated per-tensor scale."""
    q = torch.round(x.to(torch.float32) * (QMAX / scale))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


# ---------------------------------------------------------------------------
# exact int8 products
# ---------------------------------------------------------------------------


def _pad_to(n: int, m: int) -> int:
    return -n % m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> exact int32 (M, N) by torch._int_mm,
    zero-padding K and N to multiples of 8 and M to at least 17 rows."""
    M, K = a.shape
    N = b.shape[1]
    pk, pn, pm = _pad_to(K, 8), _pad_to(N, 8), max(0, 17 - M)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :N] if (pm or pn) else out


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                padding=((0, 0), (0, 0))) -> torch.Tensor:
    """int8 NHWC x (B, H, W, I) with int8 HWIO w (kh, kw, I, O) -> exact
    int32 NHWC, zero padding ((top, bottom), (left, right)): the im2col
    of the kh * kw taps (tap-major, then input channel, as HWIO flattens)
    times the flattened kernel."""
    (pt, pb), (pl, pr) = padding
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    B, H, W, C = x.shape
    kh, kw, _, O = w.shape
    sh, sw = stride
    Ho, Wo = (H - kh) // sh + 1, (W - kw) // sw + 1
    cols = [x[:, dy:dy + sh * (Ho - 1) + 1:sh, dx:dx + sw * (Wo - 1) + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    a = (torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0])
    out = int8_matmul(a.reshape(B * Ho * Wo, kh * kw * C),
                      w.reshape(kh * kw * C, O))
    return out.reshape(B, Ho, Wo, O)


def int8_conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride=(2, 2),
                          padding=(1, 1)) -> torch.Tensor:
    """int8 NHWC x with the int8 kernel of a torch ConvTranspose2d laid
    out (kh, kw, I, O) -> exact int32 NHWC: the transposed conv as a
    plain conv of the zero-inserted input (stride - 1 zeros between
    pixels), padded by kernel - 1 - padding, with the kernel rotated 180
    degrees in space."""
    B, H, W, C = x.shape
    kh, kw = w.shape[:2]
    sh, sw = stride
    ph, pw = padding
    if (sh, sw) != (1, 1):
        z = x.new_zeros((B, (H - 1) * sh + 1, (W - 1) * sw + 1, C))
        z[:, ::sh, ::sw] = x
        x = z
    qh, qw = kh - 1 - ph, kw - 1 - pw
    return int8_conv2d(x, w.flip(0, 1), (1, 1), ((qh, qh), (qw, qw)))


# ---------------------------------------------------------------------------
# the intercept
# ---------------------------------------------------------------------------


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _quantizable(mod) -> bool:
    """nn.Linear; 2-D nn.Conv2d / nn.ConvTranspose2d with one group, no
    dilation and zero padding given as numbers (no output_padding for the
    transposed conv)."""
    if isinstance(mod, nn.Linear):
        return True
    if isinstance(mod, nn.ConvTranspose2d):
        return (mod.groups == 1 and _pair(mod.dilation) == (1, 1)
                and _pair(mod.output_padding) == (0, 0)
                and mod.padding_mode == "zeros")
    return (isinstance(mod, nn.Conv2d) and mod.groups == 1
            and _pair(mod.dilation) == (1, 1)
            and not isinstance(mod.padding, str)
            and mod.padding_mode == "zeros")


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the module's own forward would give: autocast's where it
    is on, else the input's (JAX: the module's dtype or the input's)."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def _epilogue(acc, ws, scale, bias, x):
    y = acc.to(torch.float32) * (ws * (scale / (QMAX * QMAX)))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(_out_dtype(x))


def _int8_conv(mod: nn.Conv2d, x: torch.Tensor, scale: float):
    """NCHW in and out, as the module's forward."""
    wq, ws = quantize_weight(mod.weight.detach().permute(2, 3, 1, 0))
    xq = quantize_activation(x.permute(0, 2, 3, 1), scale)
    ph, pw = _pair(mod.padding)
    acc = int8_conv2d(xq, wq, _pair(mod.stride), ((ph, ph), (pw, pw)))
    return _epilogue(acc, ws, scale, mod.bias, x).permute(0, 3, 1, 2)


def _int8_conv_transpose(mod: nn.ConvTranspose2d, x: torch.Tensor,
                         scale: float):
    wq, ws = quantize_weight(mod.weight.detach().permute(2, 3, 0, 1))
    xq = quantize_activation(x.permute(0, 2, 3, 1), scale)
    acc = int8_conv_transpose2d(xq, wq, _pair(mod.stride),
                                _pair(mod.padding))
    return _epilogue(acc, ws, scale, mod.bias, x).permute(0, 3, 1, 2)


def _int8_dense(mod: nn.Linear, x: torch.Tensor, scale: float):
    wq, ws = quantize_weight(mod.weight.detach().t())        # (I, O)
    xq = quantize_activation(x, scale)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq)
    acc = acc.reshape(*x.shape[:-1], wq.shape[1])
    return _epilogue(acc, ws, scale, mod.bias, x)


def _int8_forward(mod, scale: float):
    if isinstance(mod, nn.Linear):
        return lambda x: _int8_dense(mod, x, scale)
    if isinstance(mod, nn.ConvTranspose2d):
        return lambda x, output_size=None: _int8_conv_transpose(mod, x,
                                                                scale)
    return lambda x: _int8_conv(mod, x, scale)


@contextlib.contextmanager
def make_quant_interceptor(model: nn.Module, scales: Mapping[str, float]):
    """Within the context every calibrated, quantizable module of `model`
    (by `named_modules()` name) runs in int8; on exit, exceptions
    included, each gets its own forward back."""
    swapped = []
    try:
        for name, mod in model.named_modules():
            scale = scales.get(name)
            if scale is None or not _quantizable(mod):
                continue
            mod.forward = _int8_forward(mod, float(scale))
            swapped.append(mod)
        yield model
    finally:
        for mod in swapped:
            del mod.forward


def quantized_apply(model: nn.Module, scales: Mapping[str, float], *args,
                    **kwargs):
    """`model(*args, **kwargs)` with the calibrated layers in int8."""
    with torch.no_grad(), make_quant_interceptor(model, scales):
        return model(*args, **kwargs)


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable,
              preprocess: Callable | None = None) -> Dict[str, float]:
    """Max-abs activation calibration: runs `model` over `batches` (each
    a model input, or mapped through `preprocess` first) and returns
    {module name: running max |input|} for every quantizable layer it
    called, the `scales` of `quantized_apply`."""
    amax: Dict[str, torch.Tensor] = {}
    hooks = []

    def hook(name):
        def fn(mod, args):
            a = args[0].detach().abs().amax().float()
            amax[name] = torch.maximum(amax[name], a) if name in amax else a
        return fn

    for name, mod in model.named_modules():
        if _quantizable(mod):
            hooks.append(mod.register_forward_pre_hook(hook(name)))
    try:
        for b in batches:
            model(preprocess(b) if preprocess is not None else b)
    finally:
        for h in hooks:
            h.remove()
    if not amax:
        raise ValueError("calibration saw no quantizable layer")
    return {k: float(v) for k, v in amax.items()}
