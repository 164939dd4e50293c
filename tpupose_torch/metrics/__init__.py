"""Pose metric library, accumulate/compute API (the port's copy of
tpupose/metrics: PCK, PCKh, MPJPE, AUC, EPE, OKS-AP and the COCO-17 OKS
sigma table). Each metric is an object with update()/compute()/reset();
everything runs on the host in float32 numpy. PDJ, PCP, DetectionMAP and
ClassifyMet wait (ROADMAP Queue A item 11).
"""

from tpupose_torch.metrics.auc import AUC, EPE
from tpupose_torch.metrics.mpjpe import MPJPE
from tpupose_torch.metrics.oks_ap import (OKS_SIGMAS, OKSAP, compute_oks,
                                          default_sigmas)
from tpupose_torch.metrics.pck import PCK
from tpupose_torch.metrics.pckh import PCKh

METRICS = {"oks_ap": OKSAP, "pck": PCK, "pckh": PCKh, "mpjpe": MPJPE,
           "auc": AUC, "epe": EPE}

__all__ = ["OKS_SIGMAS", "default_sigmas", "compute_oks", "OKSAP", "PCK",
           "PCKh", "MPJPE", "AUC", "EPE", "METRICS"]
