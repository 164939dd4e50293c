"""Flax -> PyTorch weight transfer (the port's own inverse of
tpupose/utils/convert.py).

`from_flax_simple_baseline` maps a flax SimpleBaseline variable tree
(numpy arrays) onto the state dict of
`tpupose_torch.models.simple_baseline.SimpleBaseline`, and
`from_flax_vitpose` a flax ViTPose tree onto
`tpupose_torch.models.vitpose.ViTPose`. The first serves two
uses: giving the port the JAX package's weights (serving parity, and
the same start for a training comparison), and mapping the params and
batch stats (or the EMA params) that JAX reached after some train steps
onto the port's names, to compare them with the port's own:

  - conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in);
  - flax ConvTranspose kernels (kh, kw, I, O) -> torch (I, O, kh, kw),
    rotated 180 degrees in space (flax runs the transposed conv as a
    fractionally strided correlation with the kernel as it is; torch's is
    the gradient of a correlation);
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    LayerNorm scale/bias -> weight/bias.
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

    _heatmap_head(sd, P["HeatmapHead_0"], S["HeatmapHead_0"])
    return sd


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(sd: dict, prefix: str, p: Mapping):
    """flax Dense {kernel (in, out), bias} -> torch Linear (out, in)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd: dict, prefix: str, p: Mapping):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _heatmap_head(sd: dict, hp: Mapping, hs: Mapping):
    """ConvTranspose_i / BatchNorm_i / Conv_0 of a flax deconv head ->
    the port's HeatmapHead under `head.`."""
    i = 0
    while f"ConvTranspose_{i}" in hp:
        sd[f"head.deconv_layers.{3 * i}.weight"] = deconv_weight(
            hp[f"ConvTranspose_{i}"]["kernel"])
        _bn(sd, f"head.deconv_layers.{3 * i + 1}", hp[f"BatchNorm_{i}"],
            hs[f"BatchNorm_{i}"])
        i += 1
    sd["head.final_layer.weight"] = conv_weight(hp["Conv_0"]["kernel"])
    sd["head.final_layer.bias"] = _t(hp["Conv_0"]["bias"])


def from_flax_vitpose(variables: Mapping) -> dict:
    """flax ViTPose {params[, batch_stats]} (numpy or jax arrays) -> state
    dict for tpupose_torch's ViTPose (float32 CPU tensors). The decoder
    is told by the tree: ConvTranspose_i (classic) or Conv_0/Conv_1
    (simple)."""
    P = variables["params"]
    S = variables.get("batch_stats", {})
    vp = P["DinoViT_0"]
    sd: dict = {}
    sd["backbone.patch_embed.proj.weight"] = conv_weight(
        vp["patch_embed"]["kernel"])
    sd["backbone.patch_embed.proj.bias"] = _t(vp["patch_embed"]["bias"])
    sd["backbone.cls_token"] = _t(vp["cls_token"])
    sd["backbone.storage_tokens"] = _t(vp["storage_tokens"])
    i = 0
    while f"ViTBlock_{i}" in vp:
        bp, t = vp[f"ViTBlock_{i}"], f"backbone.blocks.{i}"
        _ln(sd, f"{t}.norm1", bp["LayerNorm_0"])
        _dense(sd, f"{t}.attn.qkv", bp["RopeAttention_0"]["qkv"])
        _dense(sd, f"{t}.attn.proj", bp["RopeAttention_0"]["proj"])
        sd[f"{t}.ls1.gamma"] = _t(bp["ls1"])
        _ln(sd, f"{t}.norm2", bp["LayerNorm_1"])
        _dense(sd, f"{t}.mlp.fc1", bp["Dense_0"])
        _dense(sd, f"{t}.mlp.fc2", bp["Dense_1"])
        sd[f"{t}.ls2.gamma"] = _t(bp["ls2"])
        i += 1
    _ln(sd, "backbone.norm", vp["norm"])
    if "ConvTranspose_0" in P:
        _heatmap_head(sd, P, S)
    else:
        for name, key in (("head.conv", "Conv_0"),
                          ("head.final_layer", "Conv_1")):
            sd[f"{name}.weight"] = conv_weight(P[key]["kernel"])
            sd[f"{name}.bias"] = _t(P[key]["bias"])
    return sd
