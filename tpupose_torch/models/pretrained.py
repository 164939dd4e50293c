"""Pretrained-weight registry and loading (counterpart of
tpupose/models/pretrained.py).

`load_pretrained(model, pth_path, backbone)` loads a torch checkpoint of
a backbone into `model.backbone`: the checkpoints that the JAX package's
`convert_resnet`, `convert_convnext`, `convert_vit` and `load_pth`
(tpupose/utils/convert.py) take, mapped onto the port's module names:

  - ResNet: torchvision's names, which the port's ResNet keeps (conv1,
    bn1, layerX.Y.{convZ, bnZ, downsample.0/.1}); the BatchNorm running
    statistics come from the checkpoint;
  - ConvNeXt: the official names, which the port's keeps
    (downsample_layers.i, stages.i.j.{dwconv, norm, pwconv1, pwconv2,
    gamma, grn.gamma, grn.beta}); GRN's (1, 1, 1, C) parameters flattened;
  - DINOv3 ViT: the port's names (patch_embed.proj, cls_token, blocks.i.
    {norm1, attn.qkv, attn.proj, ls1, norm2, mlp.fc1, mlp.fc2, ls2}, norm),
    with `ls*.weight` read as `ls*.gamma` and `register_tokens` as
    `storage_tokens` (reshaped to (1, S, dim)).

Keys the backbone does not have (a classifier, a mask token) are left
out, as the JAX converters leave them; a key the backbone needs and the
checkpoint lacks raises. A missing file keeps the random init, with a
warning; a backbone family with no converter (HRNet) raises, as in JAX.
"""

from __future__ import annotations

import enum
import os
import re

import torch

from tpupose_torch.utils.logging import printS, printW


class Weights(enum.Enum):
    """Pretraining datasets of the DINOv3 releases."""

    LVD1689M = "lvd1689m"
    SAT493M = "sat493m"


# model name -> (family, size)
DINO_MODELS = {
    "dinov3_convnext_tiny": ("convnext", "tiny"),
    "dinov3_convnext_small": ("convnext", "small"),
    "dinov3_convnext_base": ("convnext", "base"),
    "dinov3_convnext_large": ("convnext", "large"),
    "dinov3_vits16": ("vit", "small"),
    "dinov3_vitb16": ("vit", "base"),
    "dinov3_vitl16": ("vit", "large"),
    "dinov3_vith16plus": ("vit", "huge_plus"),
    "dinov3_vit7b16": ("vit", "7b"),
}


def load_pth(path: str) -> dict:
    """A torch .pth/.pt checkpoint -> {name: tensor} on the CPU: with
    weights_only=True first, a full unpickle (warned: trusted files only)
    for a legacy checkpoint that stores other objects; a
    `model_state_dict` or `state_dict` entry is unwrapped."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        printW(f"{path}: not loadable with weights_only=True; falling back "
               "to full unpickle — only do this for trusted checkpoints")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _vit_names(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        k = re.sub(r"\.(ls[12])\.weight$", r".\1.gamma", k)
        if k in ("register_tokens", "storage_tokens"):
            k = "storage_tokens"
            v = v.reshape(1, -1, v.shape[-1])
        out[k] = v
    return out


def _convnext_names(sd: dict) -> dict:
    return {k: v.reshape(-1) if re.search(r"\.grn\.(gamma|beta)$", k) else v
            for k, v in sd.items()}


def convert_checkpoint(pth_path: str, backbone: str) -> dict:
    """torch .pth -> state dict in the port's names for the backbone
    family named by `backbone` (convnext, vit or resnet, in that order of
    precedence, as in JAX)."""
    sd = load_pth(pth_path)
    if "convnext" in backbone:
        return _convnext_names(sd)
    if "vit" in backbone:
        return _vit_names(sd)
    if "resnet" in backbone:
        return sd
    raise ValueError(f"no converter for backbone {backbone!r}")


def load_pretrained(model: torch.nn.Module, pth_path: str,
                    backbone: str) -> bool:
    """Load the converted checkpoint into `model.backbone` (parameters and
    buffers, e.g. BatchNorm running statistics) in place. Returns False,
    with a warning, where the file does not exist (the model keeps its
    init), True when loaded."""
    if not os.path.exists(pth_path):
        printW(f"pretrained checkpoint not found: {pth_path}; "
               "keeping random init")
        return False
    bb = getattr(model, "backbone", None)
    if not isinstance(bb, torch.nn.Module):
        raise ValueError(f"no backbone module found in "
                         f"{type(model).__name__}")
    sd = convert_checkpoint(pth_path, backbone)
    own = bb.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{pth_path} lacks {len(missing)} tensors of the "
                       f"{backbone} backbone, e.g. {missing[:3]}")
    bb.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)
    printS(f"loaded pretrained backbone from {pth_path}")
    return True
