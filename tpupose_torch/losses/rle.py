"""Residual Log-likelihood Estimation (RLE) for coordinate regression
(counterpart of tpupose/losses/rle.py; Li et al., ICCV 2021).

The head predicts a per-joint (mu, sigma); the loss is the negative
log-likelihood of the ground truth under a learned residual
distribution: a small RealNVP flow over the sigma-normalized 2D error,
plus an analytic Laplace or Gaussian residual term. The flow's layers
run in float32 outside any autocast region (flax's Dense(...,
dtype=float32)).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpupose_torch.losses.normalize import local_count


class _Coupling(nn.Module):
    """One RealNVP affine coupling over 2D vectors: coordinate `keep`
    passes through and conditions a scale/shift of the other one.
    `layers` are flax's Dense_0..Dense_3; the scale and shift layers
    start at zero (flax's zero kernels and biases), so the flow starts
    as the identity."""

    def __init__(self, keep: int, hidden: int = 64):
        super().__init__()
        self.keep = keep
        self.layers = nn.ModuleList([nn.Linear(1, hidden),
                                     nn.Linear(hidden, hidden),
                                     nn.Linear(hidden, 1),
                                     nn.Linear(hidden, 1)])
        with torch.no_grad():
            for lin in self.layers[2:]:
                lin.weight.zero_()
                lin.bias.zero_()

    def forward(self, z):
        a = z[:, self.keep:self.keep + 1]
        b = z[:, 1 - self.keep:2 - self.keep]
        h = torch.tanh(self.layers[0](a))
        h = torch.tanh(self.layers[1](h))
        s = torch.tanh(self.layers[2](h))
        t = self.layers[3](h)
        b = b * torch.exp(s) + t
        out = torch.cat([a, b] if self.keep == 0 else [b, a], dim=-1)
        return out, s[:, 0]


class RealNVP(nn.Module):
    """Tiny normalizing flow over 2D residuals: `layers` alternating
    couplings and a standard-normal base; (N, 2) -> (N,) exact
    log-density (the couplings' log-dets plus the base density)."""

    def __init__(self, layers: int = 3, hidden: int = 64):
        super().__init__()
        self.couplings = nn.ModuleList([_Coupling(i % 2, hidden)
                                        for i in range(layers)])

    def forward(self, r):
        with torch.autocast(r.device.type, enabled=False):
            z = r.float()
            logdet = torch.zeros(z.shape[0], device=z.device)
            for c in self.couplings:
                z, s = c(z)
                logdet = logdet + s
            base = -0.5 * (z ** 2).sum(-1) - math.log(2 * math.pi)
            return base + logdet


def rle_loss(mu, sigma, log_phi, target, visibility=None, *,
             residual: bool = True, q: str = "laplace", count=local_count):
    """RLE negative log-likelihood. mu, sigma, target (B, K, 2); log_phi
    (B, K), the flow log-density of the sigma-normalized error;
    visibility (B, K) weights, their sum normalised by `count`
    (losses/normalize.py). `residual` adds the analytic Q term, q
    "laplace" (default) or "gaussian"."""
    sigma = sigma.float()
    error = (target.float() - mu.float()) / (sigma + 1e-9)
    nll = torch.log(sigma + 1e-9).sum(-1) - log_phi            # (B, K)
    if residual:
        if q == "laplace":
            q_nll = torch.log(2.0 * sigma + 1e-9) + error.abs()
        elif q == "gaussian":
            q_nll = (torch.log(sigma * math.sqrt(2 * math.pi) + 1e-9)
                     + 0.5 * error ** 2)
        else:
            raise ValueError(f"unknown q distribution {q!r}")
        nll = nll + q_nll.sum(-1)
    if visibility is not None:
        w = visibility.float()
        return (nll * w).sum() / count(w.sum())
    return nll.mean()
