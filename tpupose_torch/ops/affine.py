"""Affine crop geometry and the train step's affine augmentation
(counterpart of tpupose/ops/affine.py: get_affine_matrix(_np),
affine_transform_points, invert_affine, transform_preds, affine_warp,
batched_affine_warp, random_affine_augment).

`batched_affine_warp` is the plain PyTorch version of the warp kernel
(tpupose_torch/csrc/warp.cu, wrapper ops/cuda_warp.affine_warp) and the
twin of the JAX oracle: float32 source coordinates, floor, four taps with
zero fill outside the image, then the two-step bilinear blend, each
operation rounded in the oracle's order. `random_affine_augment` takes
its random draws as arguments (`draw_affine_augment` makes them), so a
test can hand it the JAX package's draws.

Conventions match the MSRA SimpleBaseline `get_affine_transform`: the
destination centre is (Wo/2, Ho/2); with `udp` (unbiased data
processing) the grid is measured in unit lengths, Wo-1 intervals, and
centred at ((Wo-1)/2, (Ho-1)/2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpupose_torch._device import constant


def get_affine_matrix(center, scale, rotation_deg, out_size,
                      udp: bool = False) -> torch.Tensor:
    """dst->src affine matrices, batched over leading dims.

    center, scale: (..., 2) tensors (x, y) and (w, h) in source pixels;
    rotation_deg: float or (...) tensor; out_size: (Ho, Wo).
    Returns (..., 2, 3) with src_xy = M @ [dst_x, dst_y, 1]."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    Ho, Wo = out_size
    theta = torch.deg2rad(torch.as_tensor(rotation_deg, dtype=torch.float32,
                                          device=center.device))
    theta = theta.expand(center.shape[:-1])
    cos, sin = torch.cos(theta), torch.sin(theta)
    dw, dh = (Wo - 1.0, Ho - 1.0) if udp else (float(Wo), float(Ho))
    sx = scale[..., 0] / dw
    sy = scale[..., 1] / dh
    # src = C + R @ diag(sx, sy) @ (dst - dst_center)
    A = torch.stack([torch.stack([cos * sx, -sin * sy], -1),
                     torch.stack([sin * sx, cos * sy], -1)], -2)
    dst_c = torch.tensor([dw * 0.5, dh * 0.5] if udp else [Wo * 0.5, Ho * 0.5],
                         dtype=torch.float32, device=center.device)
    t = center - A @ dst_c
    return torch.cat([A, t[..., None]], dim=-1)


def get_affine_matrix_np(center, scale, rotation_deg, out_size,
                         udp: bool = False) -> np.ndarray:
    """NumPy twin of get_affine_matrix for one crop, for host data code."""
    Ho, Wo = out_size
    theta = math.radians(rotation_deg)
    cos, sin = math.cos(theta), math.sin(theta)
    dw, dh = (Wo - 1.0, Ho - 1.0) if udp else (float(Wo), float(Ho))
    sx = scale[0] / dw
    sy = scale[1] / dh
    A = np.array([[cos, -sin], [sin, cos]], np.float64) * np.array([sx, sy])
    dst_c = (np.array([dw * 0.5, dh * 0.5]) if udp
             else np.array([Wo * 0.5, Ho * 0.5]))
    t = np.asarray(center, np.float64) - A @ dst_c
    return np.concatenate([A, t[:, None]], axis=1).astype(np.float32)


def affine_transform_points(points, matrix):
    """Apply (..., 2, 3) affines to (..., N, 2) points (or one (2, 3) to
    (..., 2) points)."""
    if matrix.dim() > 2:
        matrix = matrix[..., None, :, :]          # broadcast over N
    x, y = points[..., 0], points[..., 1]
    nx = matrix[..., 0, 0] * x + matrix[..., 0, 1] * y + matrix[..., 0, 2]
    ny = matrix[..., 1, 0] * x + matrix[..., 1, 1] * y + matrix[..., 1, 2]
    return torch.stack([nx, ny], dim=-1)


def invert_affine(matrix):
    """Invert (..., 2, 3) affines (src->dst given dst->src)."""
    Ainv = torch.linalg.inv(matrix[..., :2])
    tinv = -(Ainv @ matrix[..., 2:])
    return torch.cat([Ainv, tinv], dim=-1)


def transform_preds(coords, center, scale, heatmap_size, udp: bool = False):
    """Heatmap-space coords (..., K, 2) -> source-image coords, given
    per-crop center/scale (..., 2) (rotation 0, as at evaluation)."""
    m = get_affine_matrix(center, scale, 0.0, heatmap_size, udp=udp)
    return affine_transform_points(coords, m)


def batched_affine_warp(images: torch.Tensor, matrices: torch.Tensor,
                        out_size) -> torch.Tensor:
    """(B, H, W, C) uint8/float images, (B, 2, 3) dst->src matrices ->
    (B, Ho, Wo, C) float32: bilinear sampling, zero fill outside the
    source. The plain version of the warp kernel."""
    B, H, W, C = images.shape
    Ho, Wo = out_size
    dev = images.device
    img = images.to(torch.float32).reshape(B, H * W, C)
    m = matrices.to(torch.float32)[:, :, :, None, None]    # (B, 2, 3, 1, 1)
    ys = torch.arange(Ho, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(Wo, dtype=torch.float32, device=dev)[None, :]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]    # (B, Ho, Wo)
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]

    def tap(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        idx = (yc * W + xc).reshape(B, Ho * Wo, 1).expand(-1, -1, C)
        v = torch.gather(img, 1, idx).reshape(B, Ho, Wo, C)
        return v * valid[..., None]

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def affine_warp(image: torch.Tensor, matrix: torch.Tensor,
                out_size) -> torch.Tensor:
    """One image (H, W, C) by one (2, 3) dst->src matrix -> (Ho, Wo, C)
    float32 (batched_affine_warp on a batch of one)."""
    return batched_affine_warp(image[None], matrix[None], out_size)[0]


def draw_affine_augment(generator: torch.Generator, batch: int,
                        rotation_factor: float, scale_factor: float,
                        rot_prob: float = 0.6):
    """Random scale multipliers and rotations (degrees), each (B,), on the
    generator's device, drawn as the JAX package draws them (and as the
    host path tpupose/data/coco.py _sample_params does): multiplier
    clip(1 + N(0,1)*sf, 1-sf, 1+sf); rotation clip(N(0,1)*rf, +-2rf)
    with probability rot_prob, else 0."""
    dev = generator.device
    n_s = torch.randn(batch, generator=generator, device=dev)
    n_r = torch.randn(batch, generator=generator, device=dev)
    u = torch.rand(batch, generator=generator, device=dev)
    mult = torch.clamp(1.0 + n_s * scale_factor, 1.0 - scale_factor,
                       1.0 + scale_factor)
    rot = torch.clamp(n_r * rotation_factor, -2.0 * rotation_factor,
                      2.0 * rotation_factor)
    rot = torch.where(u < rot_prob, rot, torch.zeros_like(rot))
    return mult, rot


def augment_matrices(mult, rot, image_size, udp: bool = False):
    """(B,) multipliers and rotations -> (B, 2, 3) dst->src matrices that
    scale by `mult` and rotate by `rot` about the image centre ((W/2,
    H/2), or ((W-1)/2, (H-1)/2) with udp)."""
    H, W = image_size
    theta = torch.deg2rad(rot.float())
    cos, sin = torch.cos(theta), torch.sin(theta)
    A = mult.float()[:, None, None] * torch.stack(
        [torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
    c = constant(((W - 1) * 0.5, (H - 1) * 0.5) if udp
                 else (W * 0.5, H * 0.5), A.device)
    t = c[None, :] - torch.einsum("bij,j->bi", A, c)
    return torch.cat([A, t[..., None]], dim=-1)


def random_affine_augment(images, joints, visibility, mult, rot,
                          heatmap_size, udp: bool = False):
    """Rotation/scale augmentation of a crop batch inside the train step.

    images (B, H, W, C) uint8/float crops; joints (B, K, 2) in heatmap
    pixels; visibility (B, K); mult, rot (B,) from draw_affine_augment.
    The crops are warped about the image centre by the warp kernel
    (ops/cuda_warp.affine_warp: the kernel for a CUDA tensor, the plain
    version for a CPU one); joints move by the inverse map about the
    heatmap centre, and a joint that leaves [0, Wh) x [0, Hh) gets
    visibility 0. Returns (images float32, joints, visibility)."""
    from tpupose_torch.ops.cuda_warp import affine_warp as warp

    H, W = images.shape[1], images.shape[2]
    Hh, Wh = heatmap_size
    mats = augment_matrices(mult, rot, (H, W), udp)
    out = warp(images, mats, (H, W))

    theta = torch.deg2rad(rot.float())
    cos, sin = torch.cos(theta), torch.sin(theta)
    inv_m = 1.0 / mult.float()
    Ainv = inv_m[:, None, None] * torch.stack(
        [torch.stack([cos, sin], -1), torch.stack([-sin, cos], -1)], -2)
    c_hm = constant(((Wh - 1) * 0.5, (Hh - 1) * 0.5) if udp
                    else (Wh * 0.5, Hh * 0.5), joints.device)
    jnew = torch.einsum("bij,bkj->bki", Ainv, joints.float() - c_hm) + c_hm
    inside = ((jnew[..., 0] >= 0) & (jnew[..., 0] < Wh)
              & (jnew[..., 1] >= 0) & (jnew[..., 1] < Hh))
    return out, jnew, visibility * inside.to(visibility.dtype)
