"""Fused DARK heatmap decode (counterpart of tpupose/ops/pallas_decode.py).

  - `dark_decode_reference`: the plain PyTorch version (argmax, blur,
    log, Taylor step) without DARK's amplitude renormalisation, which is a
    constant shift under the log and cancels in the derivatives, as the
    kernel drops it;
  - `dark_decode`: the wrapper of csrc/dark_decode.cu, which replaces
    pallas_decode.py `_decode_kernel`, through the torch.library op
    `tpupose_torch::dark_decode` (`dark_decode_op`) where a program is
    traced, its body straight in an eager call (_build.op_or_body). CPU
    tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    `dark_decode.launches` counts launches.

`decode_heatmaps(method="dark")` (tpupose_torch/ops/decode.py) sends CUDA
tensors here.
"""

from __future__ import annotations

import torch

from tpupose_torch.ops import _build
from tpupose_torch.ops.decode import dark_refine, get_max_preds


def dark_decode_reference(heatmaps: torch.Tensor, blur_kernel: int = 11,
                          sigma: float = 2.0):
    """(B, K, H, W) -> coords (B, K, 2), scores (B, K), float32."""
    hm = heatmaps.float()
    coords, scores = get_max_preds(hm)
    coords = dark_refine(hm, coords, blur_kernel, sigma, renormalize=False)
    return coords, scores


def dark_decode_impl(heatmaps: torch.Tensor, blur_kernel: int,
                     sigma: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of K4's torch.library op `dark_decode_op`: a CPU tensor takes the plain version, a
    CUDA tensor the fused kernel (one warp per map) or raises;
    `dark_decode.launches` rises at each launch."""
    if heatmaps.device.type == "cpu":
        c, s = dark_decode_reference(heatmaps, blur_kernel, sigma)
        return c.contiguous(), s.contiguous()
    if heatmaps.device.type != "cuda":
        raise RuntimeError(f"dark_decode: unsupported device "
                           f"{heatmaps.device}")
    if heatmaps.dim() != 4:
        raise ValueError(f"dark_decode: expected (B, K, H, W), got "
                         f"{tuple(heatmaps.shape)}")
    if blur_kernel % 2 != 1 or blur_kernel > 31:
        raise ValueError("dark_decode: blur_kernel must be odd and <= 31")
    B, K, H, W = heatmaps.shape
    hm = heatmaps.float().contiguous()
    coords = torch.empty((B, K, 2), dtype=torch.float32, device=hm.device)
    scores = torch.empty((B, K), dtype=torch.float32, device=hm.device)
    if B * K == 0:
        return coords, scores
    fn = _build.bind("dark_decode.cu", "tp_dark_decode",
                     [_build.PTR] * 3 + [_build.INT] * 4
                     + [_build.FLOAT, _build.PTR])
    _build.check(fn(hm.data_ptr(), coords.data_ptr(), scores.data_ptr(),
                    B * K, H, W, blur_kernel, float(sigma),
                    _build.stream_of(hm)), "dark_decode")
    dark_decode.launches += 1
    return coords, scores


dark_decode_op = torch.library.custom_op(
    "tpupose_torch::dark_decode", dark_decode_impl, mutates_args=())


@dark_decode_op.register_fake
def _dark_decode_fake(heatmaps, blur_kernel, sigma):
    B, K = heatmaps.shape[:2]
    return (heatmaps.new_empty((B, K, 2), dtype=torch.float32),
            heatmaps.new_empty((B, K), dtype=torch.float32))


def dark_decode(heatmaps: torch.Tensor, blur_kernel: int = 11,
                sigma: float = 2.0):
    """(B, K, H, W) -> coords (B, K, 2), scores (B, K). CPU: plain
    version; CUDA: the fused kernel; through the op `dark_decode_op`
    where a program is traced (_build.op_or_body)."""
    return _build.op_or_body(dark_decode_op, dark_decode_impl)(
        heatmaps, int(blur_kernel), float(sigma))


dark_decode.launches = 0
