"""Pose metric library, accumulate/compute API (the port's copy of
tpupose/metrics): PCK, PCKh, PDJ, PCP, PCPm, MPJPE, AUC, EPE, OKS-AP,
box mAP (DetectionMAP), classification metrics (ClassifyMet), the
COCO-17 OKS sigma table and mask_iou, with the registry's aliases PMet,
DMet and CMet. Each metric is an object with update()/compute()/reset();
everything runs on the host in numpy (float32 where the JAX package
computes in jnp's float32).
"""

import numpy as np

from tpupose_torch.metrics.auc import AUC, EPE
from tpupose_torch.metrics.cls import ClassifyMet
from tpupose_torch.metrics.det_map import DetectionMAP, box_iou_np
from tpupose_torch.metrics.mpjpe import MPJPE
from tpupose_torch.metrics.oks_ap import (OKS_SIGMAS, OKSAP, compute_oks,
                                          default_sigmas)
from tpupose_torch.metrics.pck import PCK
from tpupose_torch.metrics.pckh import PCKh
from tpupose_torch.metrics.pcp import PCP, PCPm
from tpupose_torch.metrics.pdj import PDJ

PMet = OKSAP
DMet = DetectionMAP
CMet = ClassifyMet


def mask_iou(a, b):
    """IoU between boolean masks: a (N, H, W), b (M, H, W) -> (N, M)."""
    a = np.asarray(a, bool).reshape(a.shape[0], -1)
    b = np.asarray(b, bool).reshape(b.shape[0], -1)
    inter = (a[:, None, :] & b[None, :, :]).sum(-1)
    union = (a[:, None, :] | b[None, :, :]).sum(-1)
    return inter / np.maximum(union, 1)


METRICS = {
    "oks_ap": OKSAP, "pck": PCK, "pckh": PCKh, "pdj": PDJ,
    "pcp": PCP, "pcpm": PCPm, "mpjpe": MPJPE, "auc": AUC, "epe": EPE,
    "det_map": DetectionMAP, "classify": ClassifyMet,
}

__all__ = ["OKS_SIGMAS", "default_sigmas", "compute_oks", "OKSAP", "PCK",
           "PCKh", "PDJ", "PCP", "PCPm", "MPJPE", "AUC", "EPE",
           "DetectionMAP", "ClassifyMet", "PMet", "DMet", "CMet", "mask_iou",
           "box_iou_np", "METRICS"]
