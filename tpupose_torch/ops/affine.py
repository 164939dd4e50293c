"""Affine crop geometry for top-down pose (counterpart of
tpupose/ops/affine.py: get_affine_matrix(_np), affine_transform_points,
invert_affine, transform_preds).

Conventions match the MSRA SimpleBaseline `get_affine_transform`: the
destination centre is (Wo/2, Ho/2); with `udp` (unbiased data
processing) the grid is measured in unit lengths, Wo-1 intervals, and
centred at ((Wo-1)/2, (Ho-1)/2).
"""

from __future__ import annotations

import math

import numpy as np
import torch


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
