"""Classification losses (counterpart of tpupose/losses/classify.py):
BCE with logits, VarifocalLoss, binary and softmax focal loss, and
cross-entropy with label smoothing. All in float32 whatever the input
dtype; elementwise (reduce outside) except the softmax ones, which
return (N,)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_cross_entropy_with_logits(logits, targets):
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def varifocal_loss(pred_logits, gt_score, label_mask, alpha: float = 0.75,
                   gamma: float = 2.0):
    """IoU-aware classification loss (VarifocalNet): BCE against the soft
    quality targets `gt_score`, weighted by the target on positives
    (`label_mask` 1) and by alpha * p^gamma on negatives."""
    p = torch.sigmoid(pred_logits.to(torch.float32))
    gt_score = gt_score.to(torch.float32)
    label_mask = label_mask.to(torch.float32)
    weight = alpha * p.pow(gamma) * (1.0 - label_mask) + gt_score * label_mask
    return binary_cross_entropy_with_logits(pred_logits, gt_score) * weight


def focal_loss(pred_logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Binary focal loss on logits; targets in {0, 1}."""
    p = torch.sigmoid(pred_logits.to(torch.float32))
    t = targets.to(torch.float32)
    ce = binary_cross_entropy_with_logits(pred_logits, t)
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    return a_t * (1 - p_t).pow(gamma) * ce


def multiclass_focal_loss(logits, labels, alpha=None, gamma: float = 2.0):
    """Softmax focal loss. logits (N, C), labels (N,) int; alpha an
    optional (C,) class weight."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = labels.to(torch.int64)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    w = (1 - torch.exp(-nll)).pow(gamma)
    if alpha is not None:
        w = w * torch.as_tensor(alpha, dtype=torch.float32,
                                device=logits.device)[labels]
    return w * nll


def cross_entropy(logits, labels, label_smoothing: float = 0.0):
    """Softmax CE with optional label smoothing. logits (N, C), labels
    (N,) -> (N,)."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    onehot = F.one_hot(labels.to(torch.int64), C).to(torch.float32)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / C
    return -(onehot * logp).sum(-1)
