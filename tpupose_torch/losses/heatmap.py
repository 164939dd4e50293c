"""JointsMSELoss for heatmap training (counterpart of
tpupose/losses/heatmap.py): 0.5 * MSE per joint, masked by the target
weights and averaged over batch and joints, plus the heatmap-weighting
variant."""

from __future__ import annotations

import torch

from tpupose_torch.losses.normalize import local_count


def _joint_weights(pred, target_weight):
    """(B, K) weights broadcast against NHWK or NKHW heatmaps; the K axis
    is the one whose size matches target_weight's last dimension."""
    K = target_weight.shape[-1]
    if pred.shape[-1] == K:                  # NHWK
        return target_weight[:, None, None, :]
    if pred.shape[1] == K:                   # NKHW
        return target_weight[:, :, None, None]
    raise ValueError("target_weight does not match any heatmap axis")


def joints_mse_loss(pred, target, target_weight=None,
                    use_target_weight: bool = True, *,
                    count=local_count) -> torch.Tensor:
    """pred/target: (B, Hh, Wh, K) or (B, K, Hh, Wh); target_weight (B, K).
    Returns a float32 scalar. With weights, the masked squared error is
    normalised by count(weight sum) (losses/normalize.py) times the
    pixels per map."""
    pred = pred.float()
    target = target.float()
    if pred.dim() != 4:
        raise ValueError("expected 4D heatmaps")
    if target_weight is not None and use_target_weight:
        target_weight = target_weight.float()
        K = target_weight.shape[-1]
        se = (pred - target) ** 2 * _joint_weights(pred, target_weight)
        denom = count(target_weight.sum())
        per_px = pred.numel() / (pred.shape[0] * K)
        return 0.5 * se.sum() / (denom * per_px)
    return 0.5 * torch.mean((pred - target) ** 2)


def joints_mse_weighted_loss(pred, target, target_weight=None,
                             peak_weight: float = 9.0, *,
                             count=local_count) -> torch.Tensor:
    """Heatmap-weighting MSE (arXiv:2205.10611): per-pixel weight
    1 + peak_weight * target; otherwise as joints_mse_loss."""
    pred = pred.float()
    target = target.float()
    if pred.dim() != 4:
        raise ValueError("expected 4D heatmaps")
    se = (pred - target) ** 2 * (1.0 + peak_weight * target)
    if target_weight is not None:
        target_weight = target_weight.float()
        K = target_weight.shape[-1]
        se = se * _joint_weights(pred, target_weight)
        denom = count(target_weight.sum())
        per_px = pred.numel() / (pred.shape[0] * K)
        return 0.5 * se.sum() / (denom * per_px)
    return 0.5 * torch.mean(se)


def coord_mse_loss(pred, target, visibility=None, *, count=local_count):
    """Direct coordinate-regression loss (the DeepPose objective): squared
    error of normalized joint coordinates summed over x and y, averaged
    over the visible joints. pred/target (B, K, 2) in [0, 1];
    visibility (B, K)."""
    se = ((pred.float() - target.float()) ** 2).sum(-1)      # (B, K)
    if visibility is not None:
        m = (visibility > 0).float()
        return (se * m).sum() / count(m.sum())
    return se.mean()
