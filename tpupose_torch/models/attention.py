"""Attention modules: multi-head self-attention and GatedAttention
(counterpart of tpupose/models/attention.py).

  - `Attention`: standard MHSA, qkv projection (`qkv`, flax `Dense_0`)
    and output projection (`proj`, flax `Dense_1`);
  - `GatedAttention`: the attention output times a sigmoid gate of the
    input, Y' = Y * sigmoid(X W_g), `headwise` (one gate a head) or
    `elementwise` (one a channel); `return_gate` also returns the gate
    scores. Names `qkv`, `gate`, `proj`, as flax's.

Both attend as jax.nn.dot_product_attention does: scores in float32
(1/sqrt(head_dim) scale), plus an additive float bias, softmax in float32,
probabilities cast to v's dtype before the product with v. They never go
through ops/attention.fused_attention, so no hand kernel runs here (the
JAX modules run XLA's attention, not a Pallas kernel). The mask is
True = attend, (B, T) or (B, T, T); a (B, T) mask becomes m[:, None, :] &
m[:, :, None], and masked pairs get a bias of -1e9, never a boolean mask:
a fully masked query row then softmaxes to uniform weights, as in JAX,
where a boolean mask gives NaN. The plain product is differentiable
twice (second-order MAML through models/fskd.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

_GATE_MODES = ("elementwise", "headwise")


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """True = attend mask (B, T) or (B, T, T) -> additive float32 bias
    (B, 1, T, T): 0 where attended, -1e9 elsewhere."""
    if mask.dim() == 2:
        mask = mask[:, None, :] & mask[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None], zero, torch.full_like(zero, -1e9))


def attend(q, k, v, mask=None):
    """softmax(q k^T / sqrt(d) + bias) v over (B, T, heads, d) tensors,
    scores and softmax in float32 (autocast off); returns (B, T, heads, d)
    in v's dtype."""
    with torch.autocast(q.device.type, enabled=False):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            / math.sqrt(q.shape[-1])
        if mask is not None:
            s = s + mask_bias(mask)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _split_heads(qkv, heads: int):
    B, T, three_dim = qkv.shape
    return qkv.view(B, T, 3, heads, three_dim // (3 * heads)).unbind(2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        B, T, _ = x.shape
        q, k, v = _split_heads(self.qkv(x), self.num_heads)
        return self.proj(attend(q, k, v, mask).reshape(B, T, self.dim))


class GatedAttention(nn.Module):
    """SDPA with an input-conditioned sigmoid output gate; gate scores
    (B, T, dim) elementwise, (B, T, heads) headwise."""

    def __init__(self, dim: int, num_heads: int = 8,
                 gate_mode: str = "elementwise", qkv_bias: bool = True):
        super().__init__()
        if gate_mode not in _GATE_MODES:
            raise ValueError(f"unknown gate_mode {gate_mode!r}")
        self.dim, self.num_heads, self.gate_mode = dim, num_heads, gate_mode
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.gate = nn.Linear(dim, num_heads if gate_mode == "headwise"
                              else dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None, return_gate: bool = False):
        B, T, _ = x.shape
        q, k, v = _split_heads(self.qkv(x), self.num_heads)
        y = attend(q, k, v, mask)                          # (B, T, h, hd)
        gate = torch.sigmoid(self.gate(x))
        if self.gate_mode == "headwise":
            y = y * gate[..., None].to(y.dtype)
        else:
            y = y.reshape(B, T, self.dim) * gate.to(y.dtype)
        out = self.proj(y.reshape(B, T, self.dim))
        return (out, gate) if return_gate else out
