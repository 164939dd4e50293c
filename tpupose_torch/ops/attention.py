"""Attention for the ViT backbone (counterpart of tpupose/ops/attention.py).

  - `attention_reference(q, k, v, scale)`: the plain version,
    softmax(scale * q k^T) v with the scores, the softmax and the product
    in float32, returned in the input dtype;
  - `attention_backward_reference(q, k, v, do, scale)`: the plain version
    of the backward, (dq, dk, dv) in float32, returned in the input dtype;
    the tests and the card checks hold K8b to it, nothing on the training
    path calls it;
  - `fused_attention(q, k, v, scale=None, impl="kernel")`: the dispatch.
    A CPU tensor takes the plain version (and autograd of it for the
    gradients); a CUDA tensor launches the hand-written flash-attention
    kernel K8 (ops/cuda_attention, csrc/flash_attention.cu), whose
    backward is the hand-written K8b (csrc/flash_attention_bwd.cu), or
    raises: bf16 with head dim 64 only. `impl="plain"` runs the plain
    version on any device; nothing on the serving or training path sets
    it (the card checks and the tests do).

q/k/v are (B, L, heads, head_dim), the JAX layout. The default scale is
1/sqrt(head_dim). The JAX dispatch's conditions `Lp <= 1792` and `L > 1`
exist because its TPU kernel keeps the whole (Lp, Lp) score tile of a
(batch, head) in VMEM; K8 and K8b stream 64-row tiles, so they take any
L >= 1 and the port has no such branch.
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


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 scale: float):
    """(dq, dk, dv) of attention_reference for the output gradient do, in
    q's dtype; float32 inside: P = softmax(scale q k^T), dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(dO O)), dQ = scale dS K,
    dK = scale dS^T Q. O is attention_reference's output in q's dtype (a
    kernel's stored O), as K8b takes it."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale,
                      dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o).sum(-1).permute(0, 2, 1)[..., None]     # (B, h, L, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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
