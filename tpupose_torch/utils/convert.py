"""Flax -> PyTorch weight transfer (the port's own inverse of
tpupose/utils/convert.py).

`from_flax_simple_baseline` maps a flax SimpleBaseline variable tree
(numpy arrays) onto the state dict of
`tpupose_torch.models.simple_baseline.SimpleBaseline`. It serves two
uses: giving the port the JAX package's weights (serving parity, and
the same start for a training comparison), and mapping the params and
batch stats (or the EMA params) that JAX reached after some train steps
onto the port's names, to compare them with the port's own:

  - conv kernels HWIO -> OIHW;
  - flax ConvTranspose kernels (kh, kw, I, O) -> torch (I, O, kh, kw),
    rotated 180 degrees in space (flax runs the transposed conv as a
    fractionally strided correlation with the kernel as it is; torch's is
    the gradient of a correlation);
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpupose_torch.models.backbones.resnet import _SPECS, Bottleneck


def conv_weight(k) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))))


def deconv_weight(k) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d
    weight (I, O, kh, kw), spatially rotated 180 degrees."""
    k = np.asarray(k, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k,
                                                              (2, 3, 0, 1))))


def _bn(sd: dict, prefix: str, p: Mapping, s: Mapping):
    sd[f"{prefix}.weight"] = torch.from_numpy(np.asarray(p["scale"],
                                                         np.float32))
    sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32))
    sd[f"{prefix}.running_mean"] = torch.from_numpy(np.asarray(s["mean"],
                                                               np.float32))
    sd[f"{prefix}.running_var"] = torch.from_numpy(np.asarray(s["var"],
                                                              np.float32))
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _stage_sizes(params: Mapping):
    """The flax tree names blocks Bottleneck_i / BasicBlock_i; the block
    type and count identify the ResNet depth."""
    for kind in ("Bottleneck", "BasicBlock"):
        n = sum(1 for k in params if k.startswith(kind + "_"))
        if n:
            for block, sizes in _SPECS.values():
                if block.__name__ == kind and sum(sizes) == n:
                    return kind, sizes
    raise ValueError("unrecognised ResNet block layout in the flax tree")


def from_flax_simple_baseline(variables: Mapping) -> dict:
    """flax SimpleBaseline {params, batch_stats} (numpy or jax arrays) ->
    state dict for tpupose_torch's SimpleBaseline (float32 CPU tensors;
    `load_state_dict` casts them to the model's dtype and device)."""
    P, S = variables["params"], variables["batch_stats"]
    rp, rs = P["ResNet_0"], S["ResNet_0"]
    sd: dict = {}
    sd["backbone.conv1.weight"] = conv_weight(rp["Conv_0"]["kernel"])
    _bn(sd, "backbone.bn1", rp["BatchNorm_0"], rs["BatchNorm_0"])

    kind, sizes = _stage_sizes(rp)
    n_convs = 3 if kind == Bottleneck.__name__ else 2
    bidx = 0
    for li, size in enumerate(sizes):
        for j in range(size):
            bp, bs = rp[f"{kind}_{bidx}"], rs[f"{kind}_{bidx}"]
            t = f"backbone.layer{li + 1}.{j}"
            for c in range(n_convs):
                sd[f"{t}.conv{c + 1}.weight"] = conv_weight(
                    bp[f"Conv_{c}"]["kernel"])
                _bn(sd, f"{t}.bn{c + 1}", bp[f"BatchNorm_{c}"],
                    bs[f"BatchNorm_{c}"])
            if f"Conv_{n_convs}" in bp:
                sd[f"{t}.downsample.0.weight"] = conv_weight(
                    bp[f"Conv_{n_convs}"]["kernel"])
                _bn(sd, f"{t}.downsample.1", bp[f"BatchNorm_{n_convs}"],
                    bs[f"BatchNorm_{n_convs}"])
            bidx += 1

    hp, hs = P["HeatmapHead_0"], S["HeatmapHead_0"]
    i = 0
    while f"ConvTranspose_{i}" in hp:
        sd[f"head.deconv_layers.{3 * i}.weight"] = deconv_weight(
            hp[f"ConvTranspose_{i}"]["kernel"])
        _bn(sd, f"head.deconv_layers.{3 * i + 1}", hp[f"BatchNorm_{i}"],
            hs[f"BatchNorm_{i}"])
        i += 1
    sd["head.final_layer.weight"] = conv_weight(hp["Conv_0"]["kernel"])
    sd["head.final_layer.bias"] = torch.from_numpy(
        np.asarray(hp["Conv_0"]["bias"], np.float32))
    return sd
