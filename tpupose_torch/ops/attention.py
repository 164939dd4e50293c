"""Attention for the ViT backbone (counterpart of tpupose/ops/attention.py).

  - `attention_reference(q, k, v, scale)`: the plain version,
    softmax(scale * q k^T) v with the scores, the softmax and the product
    in float32, returned in the input dtype;
  - `fused_attention(q, k, v, scale=None, impl="kernel")`: the dispatch.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    hand-written flash-attention kernel K8 (ops/cuda_attention,
    csrc/flash_attention.cu) or raises: bf16 with head dim 64 only.
    `impl="plain"` runs the plain version on any device; nothing on the
    serving path sets it (the card checks and the tests do).

q/k/v are (B, L, heads, head_dim), the JAX layout. The default scale is
1/sqrt(head_dim). The JAX dispatch's conditions `Lp <= 1792` and `L > 1`
exist because its TPU kernel keeps the whole (Lp, Lp) score tile of a
(batch, head) in VMEM; K8 streams K/V through 64-key tiles, so it takes
any L >= 1 and the port has no such branch.
"""

from __future__ import annotations

import math

import torch

from tpupose_torch.ops.cuda_attention import flash_attention


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """(B, L, h, D) q/k/v -> (B, L, h, D) in q's dtype; float32 inside."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None,
                    impl: str = "kernel") -> torch.Tensor:
    """softmax(scale * q k^T) v over (B, L, heads, head_dim) tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl not in ("kernel", "plain"):
        raise ValueError(f"fused_attention: impl must be 'kernel' or "
                         f"'plain', got {impl!r}")
    if impl == "plain" or q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return flash_attention(q, k, v, scale)
