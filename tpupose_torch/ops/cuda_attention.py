"""Flash attention on the card: the wrappers of csrc/flash_attention.cu
(K8, the forward) and csrc/flash_attention_bwd.cu (K8b, the backward),
which replace the TPU kernel behind tpupose/ops/attention.py `_flash`
(the library Pallas flash_attention and its custom VJP).

`flash_attention(q, k, v, scale)` takes CUDA bf16 q/k/v of shape
(B, L, heads, 64) in that layout, read through their strides (a view cut
from a qkv projection is taken as it is: unit stride on the head dim,
the other strides multiples of 8 elements, 16-byte aligned), and returns
a contiguous (B, L, heads, 64) bf16 tensor. K8 runs as the torch.library
op `tpupose_torch::flash_attention` (`flash_attention_op`) where a
program is traced, so the program records it, and as that op's body
straight in an eager call (_build.op_or_body); on a CPU tensor the op runs the plain
version (ops/attention.fused_attention sends CPU tensors to its own plain
version and never calls this). Where autograd will need it (grad enabled
and an input that requires grad), K8 also writes each row's log-sum-exp
and the forward saves q, k, v, o and it; the backward is
`flash_attention_backward` on those, i.e. K8b (a ctypes call: no
training program is exported), and nothing else. Anything either kernel
does not take raises ValueError. `flash_attention.launches` and
`flash_attention_backward.launches` count launches (K8b's two kernels,
dq with the Delta preprocess, then dkv, count as one). K8b writes its
gradients through ctypes into plain tensors, which carry no graph, so
the backward is once_differentiable: a second-order backward through it
raises instead of silently dropping the attention terms (the TPU kernel's
backward has no derivative rule either).
"""

from __future__ import annotations

import math

import torch

from tpupose_torch.ops import _build

HEAD_DIM = 64
_LOG2E = 1.0 / math.log(2.0)


def _check(q, k, v, what="flash_attention"):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise RuntimeError(f"{what}: {name} on unsupported device "
                               f"{t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} must be bfloat16, got "
                             f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be (B, L, heads, "
                             f"head_dim), got {tuple(t.shape)}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on "
                             f"{t.device} vs q {tuple(q.shape)} on "
                             f"{q.device}")
        if t.shape[-1] != HEAD_DIM:
            raise ValueError(f"{what}: head_dim must be {HEAD_DIM}, got "
                             f"{t.shape[-1]}")
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} needs unit stride on the head "
                             f"dim, the other strides multiples of 8 and "
                             f"16-byte alignment; got strides {t.stride()}")


def _launch(q, k, v, scale: float, with_lse: bool):
    B, L, H, _ = q.shape
    o = torch.empty((B, L, H, HEAD_DIM), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, L), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * L * H == 0:
        return o, lse
    fn = _build.bind("flash_attention.cu", "tp_flash_attention",
                     [_build.PTR] * 4 + [_build.INT] * 3 + [_build.I64] * 9
                     + [_build.FLOAT, _build.PTR, _build.PTR])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, L, H, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], float(scale),
                    lse.data_ptr() if with_lse else None,
                    _build.stream_of(q)),
                 "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             scale: float):
    """(dq, dk, dv) of o = softmax(scale * q k^T) v by the hand-written
    kernel K8b, from the forward's o and log-sum-exp (K8's `lse`: float32
    (B, heads, L), log2 domain with the scale folded in). q/k/v as
    `flash_attention` takes them; o and do bf16 (B, L, heads, 64), do made
    contiguous here if it is not. Returns contiguous bf16 tensors."""
    _check(q, k, v, "flash_attention_backward")
    B, L, H, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if (t.device != q.device or t.dtype != torch.bfloat16
                or t.shape != q.shape):
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"bfloat16 {tuple(q.shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, L)):
        raise ValueError(f"flash_attention_backward: lse must be float32 "
                         f"{(B, H, L)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    o, lse, do = o.contiguous(), lse.contiguous(), do.contiguous()
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("flash_attention_backward: o and do need 16-byte "
                         "alignment")
    dq, dk, dv = (torch.empty((B, L, H, HEAD_DIM), dtype=q.dtype,
                              device=q.device) for _ in range(3))
    if B * L * H == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attention_bwd.cu", "tp_flash_attention_bwd",
                     [_build.PTR] * 10 + [_build.INT] * 3 + [_build.I64] * 9
                     + [_build.FLOAT, _build.PTR])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    float(scale), _build.stream_of(q)),
                 "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, with_lse: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of K8's torch.library op `flash_attention_op`, (o, lse):
    CUDA tensors launch the kernel
    (lse its float32 (B, heads, L) log-sum-exp in the log2 domain with the
    scale folded in, or an empty (0,) tensor without `with_lse`) or
    raise; CPU tensors take the plain version in float32, o in q's dtype.
    `flash_attention.launches` rises at each launch."""
    if q.device.type == "cpu":
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                         v.float()).to(q.dtype).contiguous()
        lse = (torch.logsumexp(s, dim=-1) * _LOG2E if with_lse
               else s.new_empty((0,)))
        return o, lse
    _check(q, k, v)
    o, lse = _launch(q, k, v, scale, with_lse)
    return o, (lse if with_lse else
               torch.empty((0,), dtype=torch.float32, device=q.device))


flash_attention_op = torch.library.custom_op(
    "tpupose_torch::flash_attention", flash_attention_impl, mutates_args=())


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, scale, with_lse):
    B, L, H, D = q.shape
    lse_shape = (B, H, L) if with_lse else (0,)
    return (q.new_empty((B, L, H, D)),
            q.new_empty(lse_shape, dtype=torch.float32))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _build.op_or_body(flash_attention_op,
                                   flash_attention_impl)(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, grad_out,
                                              ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v over (B, L, heads, 64) bf16 CUDA tensors,
    by the hand-written kernel, through the op `flash_attention_op` where
    a program is traced (_build.op_or_body); differentiable through K8b
    where autograd needs it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, float(scale))
    return _build.op_or_body(flash_attention_op, flash_attention_impl)(
        q, k, v, float(scale), False)[0]


flash_attention.launches = 0
flash_attention_backward.launches = 0
