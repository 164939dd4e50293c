"""ViTPose (Xu et al. 2022, arXiv:2204.12484) on a DINOv3 ViT (Simeoni et
al. 2025, arXiv:2508.10104) in plain float32 torch: patch embedding,
[CLS, 4 storage tokens, patches], pre-norm blocks with 2D RoPE on the
patch tokens' queries and keys, layer scales, a tanh-GELU MLP, the final
LayerNorm, and the classic decoder (deconvolutions 4x4/2 with BatchNorm
and ReLU, then a 1x1 convolution to K heatmaps).

DINOv3's RoPE as its ViT-S/16 applies it: coordinates on linspace(-1, 1)
of the patch grid, base 100, the first quarter of a head's frequencies
for y and the next for x, each head's two halves rotated (not
interleaved pairs). LayerNorm eps 1e-6. The tensors are named as the
DINOv3 checkpoints name them (`backbone.blocks.0.attn.qkv.weight`,
`backbone.storage_tokens`, `ls1.gamma`), the decoder as in
`resnet_pose`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from posebench.reference.common import quant_or_id
from posebench.reference.resnet_pose import _bn, _bn_specs

LN_EPS = 1e-6


def param_specs(w: dict):
    d, hid, p = w["dim"], w["mlp_hidden"], w["patch_size"]
    out = [("backbone.patch_embed.proj.weight", (d, 3, p, p), "linear"),
           ("backbone.patch_embed.proj.bias", (d,), "bias"),
           ("backbone.cls_token", (1, 1, d), "token"),
           ("backbone.storage_tokens", (1, w["storage_tokens"], d), "token")]
    for i in range(w["depth"]):
        b = f"backbone.blocks.{i}"
        out += [(f"{b}.norm1.weight", (d,), "ln_weight"),
                (f"{b}.norm1.bias", (d,), "ln_bias"),
                (f"{b}.attn.qkv.weight", (3 * d, d), "linear"),
                (f"{b}.attn.qkv.bias", (3 * d,), "bias"),
                (f"{b}.attn.proj.weight", (d, d), "linear"),
                (f"{b}.attn.proj.bias", (d,), "bias"),
                (f"{b}.ls1.gamma", (d,), "layer_scale"),
                (f"{b}.norm2.weight", (d,), "ln_weight"),
                (f"{b}.norm2.bias", (d,), "ln_bias"),
                (f"{b}.mlp.fc1.weight", (hid, d), "linear"),
                (f"{b}.mlp.fc1.bias", (hid,), "bias"),
                (f"{b}.mlp.fc2.weight", (d, hid), "linear"),
                (f"{b}.mlp.fc2.bias", (d,), "bias"),
                (f"{b}.ls2.gamma", (d,), "layer_scale")]
    out += [("backbone.norm.weight", (d,), "ln_weight"),
            ("backbone.norm.bias", (d,), "ln_bias")]
    cin, k = d, w["deconv_kernel"]
    for i, c in enumerate(w["deconv_channels"]):
        out += [(f"head.deconv_layers.{3 * i}.weight", (cin, c, k, k),
                 "deconv_relu")]
        out += _bn_specs(f"head.deconv_layers.{3 * i + 1}", c)
        cin = c
    out += [("head.final_layer.weight", (w["num_keypoints"], cin, 1, 1),
             "conv_out"),
            ("head.final_layer.bias", (w["num_keypoints"],), "zero")]
    return out


def rope_tables(h: int, w: int, head_dim: int, base: float, device):
    q4 = head_dim // 4
    freqs = 1.0 / base ** (torch.arange(q4, dtype=torch.float32,
                                        device=device) / q4)
    gy, gx = torch.meshgrid(torch.linspace(-1, 1, h, device=device),
                            torch.linspace(-1, 1, w, device=device),
                            indexing="ij")
    ang = torch.cat([gy.reshape(-1, 1) * freqs, gx.reshape(-1, 1) * freqs],
                    -1)
    return torch.sin(ang), torch.cos(ang)


def rope(t, sin, cos):
    """t (B, T, heads, hd); sin/cos (T, hd / 2)."""
    h = t.shape[-1] // 2
    a, b = t[..., :h], t[..., h:]
    s, c = sin[:, None], cos[:, None]
    return torch.cat([a * c - b * s, b * c + a * s], -1)


def forward(P: dict, x: torch.Tensor, w: dict, train: bool = False,
            quant: bool = False) -> torch.Tensor:
    """Normalised NCHW float32 crops -> heatmaps (B, K, H/4, W/4).
    train: the decoder's BatchNorm on the batch's statistics. quant:
    every matrix product's operands rounded to fp8 first (the control)."""
    q = quant_or_id(quant)
    d, nh, p = w["dim"], w["heads"], w["patch_size"]
    hd = d // nh
    B, _, H, W = x.shape
    ph, pw = H // p, W // p
    t = F.conv2d(q(x), q(P["backbone.patch_embed.proj.weight"]),
                 P["backbone.patch_embed.proj.bias"], stride=p)
    t = t.flatten(2).transpose(1, 2)
    pre = torch.cat([P["backbone.cls_token"], P["backbone.storage_tokens"]],
                    1)
    n = pre.shape[1]
    t = torch.cat([pre.expand(B, -1, -1), t], 1)
    T = t.shape[1]
    sin, cos = rope_tables(ph, pw, hd, w["rope_base"], x.device)

    def lin(v, name):
        return F.linear(q(v), q(P[f"{name}.weight"]), P[f"{name}.bias"])

    def ln(v, name):
        return F.layer_norm(v, (d,), P[f"{name}.weight"], P[f"{name}.bias"],
                            LN_EPS)

    for i in range(w["depth"]):
        b = f"backbone.blocks.{i}"
        qkv = lin(ln(t, f"{b}.norm1"), f"{b}.attn.qkv").view(B, T, 3, nh, hd)
        qq, kk, vv = qkv.unbind(2)
        qq = torch.cat([qq[:, :n], rope(qq[:, n:], sin, cos)], 1)
        kk = torch.cat([kk[:, :n], rope(kk[:, n:], sin, cos)], 1)
        s = torch.einsum("bqhd,bkhd->bhqk", q(qq), q(kk)) / math.sqrt(hd)
        a = torch.einsum("bhqk,bkhd->bqhd", q(torch.softmax(s, -1)), q(vv))
        t = t + P[f"{b}.ls1.gamma"] * lin(a.reshape(B, T, d),
                                          f"{b}.attn.proj")
        m = F.gelu(lin(ln(t, f"{b}.norm2"), f"{b}.mlp.fc1"),
                   approximate="tanh")
        t = t + P[f"{b}.ls2.gamma"] * lin(m, f"{b}.mlp.fc2")
    t = ln(t, "backbone.norm")
    f = t[:, n:].transpose(1, 2).reshape(B, d, ph, pw)
    for i in range(len(w["deconv_channels"])):
        f = F.conv_transpose2d(q(f), q(P[f"head.deconv_layers.{3 * i}.weight"]),
                               stride=2, padding=1)
        f = F.relu(_bn(f, P, f"head.deconv_layers.{3 * i + 1}", train))
    return F.conv2d(q(f), q(P["head.final_layer.weight"]),
                    P["head.final_layer.bias"])
