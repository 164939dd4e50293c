"""DINOv3-style Vision Transformer with 2D RoPE and storage tokens
(counterpart of tpupose/models/backbones/vit.py).

Parameter names follow the DINOv3 checkpoints (patch_embed.proj,
cls_token, storage_tokens, blocks.i.{norm1, attn.qkv, attn.proj,
ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}, norm);
utils/convert.from_flax_vitpose maps the flax tree onto them.

Where the port must not differ from flax:
  - GELU is the tanh form (flax.linen.gelu's default), not torch's erf;
  - LayerNorm epsilon is 1e-6 (torch's default is 1e-5);
  - q|k|v are split first and heads second;
  - RoPE: linspace(-1, 1) grids, base 100, y frequencies then x, rotation
    of the two halves (not interleaved pairs), sin/cos cast to q's dtype
    before the products, patch tokens only;
  - token order [cls, storage x 4, patches row-major].

Attention goes through ops/attention.fused_attention: the hand-written
flash kernels on the card (K8 forward, K8b backward), the plain version
on the CPU. `RopeAttention.impl` selects "kernel" (default) or "plain".
`DinoViT(remat=True)` checkpoints each block while gradients are
recorded (torch.utils.checkpoint, non-reentrant): the counterpart of
tpupose's `remat_call` (tpupose/models/remat.py). It keeps the parameter
names, and the block's forward (K8 included) runs again in the backward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpupose_torch.ops.attention import fused_attention

VIT_SIZES = {
    "small": {"depth": 12, "dim": 384, "heads": 6},
    "small_plus": {"depth": 12, "dim": 384, "heads": 6},
    "base": {"depth": 12, "dim": 768, "heads": 12},
    "large": {"depth": 24, "dim": 1024, "heads": 16},
    "huge_plus": {"depth": 32, "dim": 1280, "heads": 20},
    "7b": {"depth": 40, "dim": 4096, "heads": 32},
}

LN_EPS = 1e-6


def rope_2d_sincos(h: int, w: int, dim: int, base: float = 100.0,
                   dtype=torch.float32, device=None):
    """Axial 2D RoPE tables for an (h, w) patch grid: (sin, cos), each
    (h*w, dim//2); the first dim//4 frequencies encode y, the next x,
    with coordinates in [-1, 1]."""
    if dim % 4:
        raise ValueError(f"head_dim must be divisible by 4 for 2D RoPE, "
                         f"got {dim}")
    quarter = dim // 4
    freqs = 1.0 / (base ** (torch.arange(quarter, dtype=torch.float32,
                                         device=device) / quarter))
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ang = torch.cat([gy.reshape(-1, 1) * freqs, gx.reshape(-1, 1) * freqs],
                    dim=-1)
    return torch.sin(ang).to(dtype), torch.cos(ang).to(dtype)


def apply_rope(q: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """Rotate the two halves of q (B, T, heads, head_dim) with sin/cos
    (T, head_dim // 2), cast to q's dtype first."""
    d2 = q.shape[-1] // 2
    q1, q2 = q[..., :d2], q[..., d2:]
    sin = sin[:, None, :].to(q.dtype)
    cos = cos[:, None, :].to(q.dtype)
    return torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)


class RopeAttention(nn.Module):
    """MHSA with 2D RoPE on the patch tokens (the first `num_prefix`
    tokens, CLS and storage, are position-free)."""

    def __init__(self, dim: int, heads: int, num_prefix: int):
        super().__init__()
        self.dim, self.heads, self.num_prefix = dim, heads, num_prefix
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.impl = "kernel"

    def forward(self, x, sin, cos):
        B, T, _ = x.shape
        q, k, v = self.qkv(x).view(B, T, 3, self.heads,
                                   self.dim // self.heads).unbind(2)
        p = self.num_prefix
        q = torch.cat([q[:, :p], apply_rope(q[:, p:], sin, cos)], dim=1)
        k = torch.cat([k[:, :p], apply_rope(k[:, p:], sin, cos)], dim=1)
        out = fused_attention(q, k, v, impl=self.impl)
        return self.proj(out.reshape(B, T, self.dim))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, num_prefix: int,
                 mlp_ratio: float = 4.0, layer_scale_init: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = RopeAttention(dim, heads, num_prefix)
        self.ls1 = LayerScale(dim, layer_scale_init)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, layer_scale_init)

    def forward(self, x, sin, cos):
        x = x + self.ls1(self.attn(self.norm1(x), sin, cos))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


class DinoViT(nn.Module):
    """DINOv3-architecture ViT feature extractor. NHWC (B, H, W, 3) in
    (H, W multiples of patch_size) -> dict with "cls" (B, C), "storage"
    (B, S, C), "patches" (B, N, C), "feature_map" (B, H/p, W/p, C) and,
    when `intermediates` names blocks, "intermediates" {i: (B, H/p, W/p,
    C)} of those blocks' outputs (before the final norm). `remat`
    recomputes each block in the backward instead of keeping its
    activations."""

    def __init__(self, depth: int = 12, dim: int = 384, heads: int = 6,
                 patch_size: int = 16, num_storage_tokens: int = 4,
                 intermediates: Sequence[int] = (), remat: bool = False):
        super().__init__()
        self.dim, self.heads, self.patch_size = dim, heads, patch_size
        self.remat = remat
        self.num_prefix = 1 + num_storage_tokens
        self.intermediates = tuple(intermediates)
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.storage_tokens = nn.Parameter(
            torch.zeros(1, num_storage_tokens, dim))
        self.blocks = nn.ModuleList(
            ViTBlock(dim, heads, self.num_prefix) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    @classmethod
    def from_size(cls, size: str, intermediates=(), **kw):
        if size not in VIT_SIZES:
            raise ValueError(f"unknown vit size {size!r}; have "
                             f"{sorted(VIT_SIZES)}")
        s = VIT_SIZES[size]
        return cls(depth=s["depth"], dim=s["dim"], heads=s["heads"],
                   intermediates=intermediates, **kw)

    def forward(self, x):
        B, H, W, _ = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size {(H, W)} is not a multiple of the "
                             f"patch size {p}")
        ph, pw = H // p, W // p
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                  # (B, ph*pw, C)
        prefix = torch.cat([self.cls_token, self.storage_tokens], dim=1)
        x = torch.cat([prefix.to(x.dtype).expand(B, -1, -1), x], dim=1)
        sin, cos = rope_2d_sincos(ph, pw, self.dim // self.heads,
                                  device=x.device)
        n = self.num_prefix
        inter = {}
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                x = checkpoint(blk, x, sin, cos, use_reentrant=False)
            else:
                x = blk(x, sin, cos)
            if i in self.intermediates:
                inter[i] = x[:, n:].reshape(B, ph, pw, self.dim)
        x = self.norm(x)
        out = {"cls": x[:, 0], "storage": x[:, 1:n], "patches": x[:, n:],
               "feature_map": x[:, n:].reshape(B, ph, pw, self.dim)}
        if inter:
            out["intermediates"] = inter
        return out
