"""Batched affine warp (counterpart of tpupose/ops/pallas_warp.py).

  - `affine_warp(images, matrices, out_size)`: (B, Hs, Ws, C) uint8 or
    float32 NHWC images and (B, 2, 3) dst->src matrices -> (B, Ho, Wo, C)
    float32, bilinear with zero fill. Replaces `pallas_affine_warp`.
  - `crops_from_frames(frames, matrices, out_size)`: (B, Hs, Ws, C)
    frames and (B*D, 2, 3) matrices -> (B*D, Ho, Wo, C); crop n reads
    frame n // D, without copying the frames. Replaces
    `pallas_crops_from_frames`.

Both are wrappers of csrc/warp.cu (a block a 64 x 16 output tile: the
tile's source footprint staged in shared memory by cp.async, the output
written by 16-byte stores; a tile whose footprint does not fit gathers
from device memory), which replaces the TPU kernel `_warp_kernel`. A CPU tensor takes the plain version
(ops/affine.batched_affine_warp, after `repeat_interleave` of the frames
for the crops); a CUDA tensor launches the kernel or raises. Any output
size is taken (the TPU kernel's Ho % 8 rule was a tile constraint).
Other input dtypes than uint8 and float32 are cast to float32 first; a
non-contiguous input is made contiguous (a copy) before the launch.
`affine_warp.launches` and `crops_from_frames.launches` count launches.
Either takes `gather_count`, an int32 tensor of one element on the card,
to which the kernel adds the number of tiles that gathered from device
memory.
"""

from __future__ import annotations

import torch

from tpupose_torch.ops import _build
from tpupose_torch.ops.affine import batched_affine_warp


def _plain_crops(frames, matrices, out_size):
    D = matrices.shape[0] // frames.shape[0]
    return batched_affine_warp(frames.repeat_interleave(D, dim=0), matrices,
                               out_size)


def _check(src, matrices, out_size, what):
    if src.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {src.device}")
    if src.dim() != 4:
        raise ValueError(f"{what}: expected (B, H, W, C) images, got "
                         f"{tuple(src.shape)}")
    if matrices.dim() != 3 or tuple(matrices.shape[1:]) != (2, 3):
        raise ValueError(f"{what}: expected (N, 2, 3) matrices, got "
                         f"{tuple(matrices.shape)}")
    if matrices.device != src.device:
        raise ValueError(f"{what}: matrices on {matrices.device}, images on "
                         f"{src.device}")
    Ho, Wo = (int(v) for v in out_size)
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"{what}: bad out_size {out_size}")
    return Ho, Wo


def _launch(src, matrices, out_size, D, what, gather_count):
    """Launch csrc/warp.cu on CUDA tensors: src (N/D, Hs, Ws, C) frames,
    matrices (N, 2, 3); returns (N, Ho, Wo, C) float32."""
    Ho, Wo = _check(src, matrices, out_size, what)
    if gather_count is not None and (
            gather_count.dtype != torch.int32 or gather_count.numel() != 1
            or gather_count.device != src.device):
        raise ValueError(f"{what}: gather_count must be one int32 on "
                         f"{src.device}")
    if src.dtype not in (torch.uint8, torch.float32):
        src = src.float()
    src = src.contiguous()
    mats = matrices.to(torch.float32).contiguous()
    N = mats.shape[0]
    _, Hs, Ws, C = src.shape
    out = torch.empty((N, Ho, Wo, C), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    fn = _build.bind("warp.cu", "tp_affine_warp",
                     [_build.PTR] * 3 + [_build.INT] * 8 + [_build.PTR] * 2)
    _build.check(fn(src.data_ptr(), mats.data_ptr(), out.data_ptr(),
                    int(src.dtype == torch.uint8), N, Hs, Ws, C, Ho, Wo, D,
                    None if gather_count is None else gather_count.data_ptr(),
                    _build.stream_of(src)), what)
    return out


def affine_warp(images: torch.Tensor, matrices: torch.Tensor,
                out_size, gather_count=None) -> torch.Tensor:
    """(B, Hs, Ws, C), (B, 2, 3) -> (B, Ho, Wo, C) float32. CPU: plain
    version; CUDA: the kernel."""
    if images.device.type == "cpu":
        return batched_affine_warp(images, matrices, out_size)
    if matrices.shape[0] != images.shape[0]:
        raise ValueError(f"affine_warp: {matrices.shape[0]} matrices for "
                         f"{images.shape[0]} images")
    out = _launch(images, matrices, out_size, 1, "affine_warp", gather_count)
    affine_warp.launches += 1
    return out


def crops_from_frames(frames: torch.Tensor, matrices: torch.Tensor,
                      out_size, gather_count=None) -> torch.Tensor:
    """(B, Hs, Ws, C) frames, (B*D, 2, 3) matrices -> (B*D, Ho, Wo, C)
    float32, crop n from frame n // D. CPU: plain version; CUDA: the
    kernel with the D-crops-per-frame index."""
    B, N = frames.shape[0], matrices.shape[0]
    if B == 0 or N % B:
        raise ValueError(f"matrices ({N}) must be a multiple of frames ({B})")
    if frames.device.type == "cpu":
        return _plain_crops(frames, matrices, out_size)
    out = _launch(frames, matrices, out_size, N // B, "crops_from_frames",
                  gather_count)
    crops_from_frames.launches += 1
    return out


affine_warp.launches = 0
crops_from_frames.launches = 0
