"""Sub-seeds and the seeded weights both sides of the comparison take."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run (weights, crops, draws...),
    from the run's --seed (any integer) and the stream's name."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _fan_in(shape, kind: str) -> int:
    if kind == "deconv_relu":          # (Cin, Cout, k, k), stride 2
        return shape[0] * shape[2] * shape[3] // 4
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def make_weights(specs, seed: int, device) -> dict:
    """{name: tensor} for [(name, shape, kind)] specs, float32 (int64 for
    counts), drawn on `device` in two calls from the run's seed:
    He-normal convolutions before a ReLU; LeCun-normal linears; the
    heatmap convolution LeCun-normal around a positive mean (its inputs
    are ReLU outputs, so every map has a positive peak, as a trained
    model's do); small biases; DINOv3-like tokens, LayerNorm affines and
    layer scales U(0.2, 0.6) (so each block shows in the output);
    BatchNorm scale U(0.5, 1), bias N(0, 0.1), running mean N(0, 0.1),
    variance U(0.5, 2); the scale of a residual branch's last BatchNorm
    U(0, 0.2), as trained ResNets have it (and torchvision's
    zero_init_residual): at U(0.5, 1) there the random-init ResNet-50 is
    chaotic, its bf16 training step's gradient as far from float64's as
    an fp8 one (PERF.md, section 6)."""
    total = 0
    for _, shape, _ in specs:
        n = 1
        for s in shape:
            n *= s
        total += n
    g = generator(seed, "weights", device)
    normal = torch.randn(total, generator=g, device=device)
    unif = torch.rand(total, generator=g, device=device)
    out, pos = {}, 0
    for name, shape, kind in specs:
        n = 1
        for s in shape:
            n *= s
        z = normal[pos:pos + n].view(shape)
        u = unif[pos:pos + n].view(shape)
        pos += n
        if kind == "count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind in ("conv_relu", "deconv_relu"):
            t = z * (2.0 / _fan_in(shape, kind)) ** 0.5
        elif kind == "linear":
            t = z * (1.0 / _fan_in(shape, kind)) ** 0.5
        elif kind == "conv_out":
            t = (z + 0.5) * (1.0 / _fan_in(shape, kind)) ** 0.5
        elif kind == "bias":
            t = z * 0.02
        elif kind == "token":
            t = z * 0.5
        elif kind == "ln_weight":
            t = 0.7 + 0.6 * u
        elif kind in ("ln_bias", "bn_bias", "bn_mean"):
            t = z * 0.1
        elif kind == "layer_scale":
            t = 0.2 + 0.4 * u
        elif kind == "bn_weight":
            t = 0.5 + 0.5 * u
        elif kind == "bn_weight_residual":
            t = 0.2 * u
        elif kind == "bn_var":
            t = 0.5 + 1.5 * u
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = t.contiguous()
    return out
