"""Flash attention forward on the card (K8): the wrapper of
csrc/flash_attention.cu, which replaces the TPU kernel behind
tpupose/ops/attention.py `_flash` (the library Pallas flash_attention).

`flash_attention(q, k, v, scale)` takes CUDA bf16 q/k/v of shape
(B, L, heads, 64) in that layout, read through their strides (a view cut
from a qkv projection is taken as it is: unit stride on the head dim,
the other strides multiples of 8 elements, 16-byte aligned), and returns
a contiguous (B, L, heads, 64) bf16 tensor. Anything else raises
ValueError; a CPU tensor raises too (ops/attention.fused_attention sends
CPU tensors to the plain version and never calls this). It is forward
only: the backward raises NotImplementedError.
`flash_attention.launches` counts launches.
"""

from __future__ import annotations

import torch

from tpupose_torch.ops import _build

HEAD_DIM = 64
_BACKWARD = ("the backward of the flash-attention kernel is not ported "
             "(ROADMAP Queue B item 9, K8b: the dq/dkv kernels of "
             "tpupose/ops/attention.py's custom VJP); train through "
             "attention with impl='plain'")


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise RuntimeError(f"flash_attention: {name} on unsupported "
                               f"device {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, "
                             f"got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, L, heads,"
                             f" head_dim), got {tuple(t.shape)}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} on "
                             f"{t.device} vs q {tuple(q.shape)} on "
                             f"{q.device}")
        if t.shape[-1] != HEAD_DIM:
            raise ValueError(f"flash_attention: head_dim must be "
                             f"{HEAD_DIM}, got {t.shape[-1]}")
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs unit stride on "
                             f"the head dim, the other strides multiples "
                             f"of 8 and 16-byte alignment; got strides "
                             f"{t.stride()}")


def _launch(q, k, v, scale: float) -> torch.Tensor:
    B, L, H, _ = q.shape
    o = torch.empty((B, L, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    if B * L * H == 0:
        return o
    fn = _build.bind("flash_attention.cu", "tp_flash_attention",
                     [_build.PTR] * 4 + [_build.INT] * 3 + [_build.I64] * 9
                     + [_build.FLOAT, _build.PTR])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, L, H, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], float(scale), _build.stream_of(q)),
                 "flash_attention")
    flash_attention.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_BACKWARD)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v over (B, L, heads, 64) bf16 CUDA tensors,
    by the hand-written kernel."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, float(scale))


flash_attention.launches = 0
