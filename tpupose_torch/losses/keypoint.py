"""Keypoint loss family (counterpart of tpupose/losses/keypoint.py): OKS,
Wing, AdaptiveWing, MultiScale and Hybrid, selectable by name
(`get_kpt_loss`). Each maps pred/target (..., K, 2), a visibility mask
(..., K) and a box area (...,) to a per-instance loss (...,), masked
instead of indexed, in float32."""

from __future__ import annotations

import math

import torch

from tpupose_torch.metrics.oks_ap import OKS_SIGMAS


def _sigmas_for(K: int, device) -> torch.Tensor:
    if K <= 17:
        return torch.as_tensor(OKS_SIGMAS[:K], device=device)
    return torch.full((K,), 0.05, dtype=torch.float32, device=device)


def _norm(d):
    return torch.linalg.vector_norm(d, dim=-1)


def oks_loss(pred, target, vis_mask, area, sigmas=None, eps: float = 1e-9):
    """YOLO-pose OKS loss: per instance the mean over visible joints of
    1 - exp(-d^2 / (2 (2 sigma)^2 (area + eps)))."""
    K = pred.shape[-2]
    sig = _sigmas_for(K, pred.device) if sigmas is None \
        else torch.as_tensor(sigmas, dtype=torch.float32, device=pred.device)
    d2 = ((pred - target) ** 2).sum(-1)
    e = d2 / ((2.0 * sig) ** 2 * (area[..., None] + eps) * 2.0)
    kpt_mask = vis_mask.to(torch.float32)
    denom = kpt_mask.sum(-1) + eps
    return ((1.0 - torch.exp(-e)) * kpt_mask).sum(-1) / denom


def wing_loss(pred, target, vis_mask, omega: float = 10.0,
              epsilon: float = 2.0):
    d = _norm(pred - target)
    C = omega - omega * math.log(1.0 + omega / epsilon)
    loss = torch.where(d < omega, omega * torch.log(1.0 + d / epsilon), d - C)
    m = vis_mask.to(torch.float32)
    return (loss * m).sum(-1) / (m.sum(-1) + 1e-9)


def adaptive_wing_loss(pred, target, vis_mask, area=None,
                       omega: float = 14.0, theta: float = 0.5,
                       epsilon: float = 1.0, alpha: float = 2.1):
    """Adaptive Wing on (optionally sqrt(area)-normalized) distances, in
    the zero-target form."""
    d = _norm(pred - target)
    if area is not None:
        d = d / (torch.sqrt(area[..., None]) + 1e-9)
    te = theta / epsilon
    a = omega * (1.0 / (1.0 + te ** (alpha - 1.0))) * (alpha - 1.0) \
        * (te ** (alpha - 2.0)) / epsilon
    c = theta * a - omega * math.log(1.0 + te ** (alpha - 1.0))
    loss = torch.where(d < theta,
                       omega * torch.log(1.0 + (d / epsilon) ** (alpha - 1.0)),
                       a * d - c)
    m = vis_mask.to(torch.float32)
    return (loss * m).sum(-1) / (m.sum(-1) + 1e-9)


def multiscale_keypoint_loss(pred, target, vis_mask, area,
                             scales=(1.0, 0.5, 0.25)):
    """OKS loss averaged over coordinate scales."""
    total = 0.0
    for s in scales:
        total = total + oks_loss(pred * s, target * s, vis_mask, area * s * s)
    return total / len(scales)


def hybrid_keypoint_loss(pred, target, vis_mask, area,
                         l1_weight: float = 0.5, smooth_weight: float = 0.1):
    """OKS + 0.5 L1 + 0.1 adjacent-joint smoothness."""
    base = oks_loss(pred, target, vis_mask, area)
    m = vis_mask.to(torch.float32)
    l1 = ((pred - target).abs().sum(-1) * m).sum(-1) / (m.sum(-1) + 1e-9)
    dp = pred[..., 1:, :] - pred[..., :-1, :]
    dt = target[..., 1:, :] - target[..., :-1, :]
    mm = m[..., 1:] * m[..., :-1]
    smooth = ((dp - dt).abs().sum(-1) * mm).sum(-1) / (mm.sum(-1) + 1e-9)
    return base + l1_weight * l1 + smooth_weight * smooth


KPT_LOSSES = {
    "oks": lambda p, t, v, a: oks_loss(p, t, v, a),
    "wing": lambda p, t, v, a: wing_loss(p, t, v),
    "adaptive_wing": lambda p, t, v, a: adaptive_wing_loss(p, t, v, a),
    "multiscale": multiscale_keypoint_loss,
    "hybrid": hybrid_keypoint_loss,
}


def get_kpt_loss(name: str):
    if name not in KPT_LOSSES:
        raise ValueError(f"unknown kpt loss {name!r}; have {sorted(KPT_LOSSES)}")
    return KPT_LOSSES[name]
