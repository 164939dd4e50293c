"""SimCC loss (counterpart of tpupose/losses/simcc.py): soft
cross-entropy of the 1D x/y bin classifications against Gaussian label
distributions (the KL target of Li et al., ECCV 2022: t log t is constant
in the parameters, so the gradients are the same). The targets are
rendered in the train step from (B, K, 2) joints in bin coordinates."""

from __future__ import annotations

import torch

from tpupose_torch.losses.normalize import local_count


def gaussian_1d_targets(joints, visibility, bins_hw, sigma: float = 6.0):
    """1D Gaussian label distributions over the x and y bins.

    joints (B, K, 2) in BIN coordinates (x, y); visibility (B, K);
    bins_hw = (Hb, Wb). Returns (tx (B, K, Wb), ty (B, K, Hb), weight
    (B, K)): each row sums to 1; the weight zeroes invisible joints and
    joints whose centre lies more than 3 sigma outside the bin range."""
    Hb, Wb = bins_hw
    joints = joints.float()
    x, y = joints[..., 0], joints[..., 1]

    def dist(center, n):
        grid = torch.arange(n, dtype=torch.float32, device=center.device)
        t = torch.exp(-0.5 * ((grid - center[..., None]) / sigma) ** 2)
        return t / torch.clamp_min(t.sum(-1, keepdim=True), 1e-12)

    m = 3.0 * sigma
    inside = (x > -m) & (x < Wb - 1 + m) & (y > -m) & (y < Hb - 1 + m)
    w = (visibility > 0).float() * inside.float()
    return dist(x, Wb), dist(y, Hb), w


def _log_softmax(z):
    """JAX's order: subtract the max, then the log of the sum of exps."""
    z = z - z.amax(-1, keepdim=True)
    return z - torch.log(torch.exp(z).sum(-1, keepdim=True))


def simcc_kl_loss(preds, target, target_weight=None, *, count=local_count):
    """preds (x_logits (B, K, Wb), y_logits (B, K, Hb)); target (tx, ty);
    target_weight (B, K). A float32 scalar normalized by count(weight
    sum) (losses/normalize.py)."""
    x_logits, y_logits = preds
    tx, ty = target
    ce = (-(tx.float() * _log_softmax(x_logits.float())).sum(-1)
          - (ty.float() * _log_softmax(y_logits.float())).sum(-1))
    if target_weight is None:
        return ce.mean()
    w = target_weight.float()
    return (ce * w).sum() / count(w.sum())
