"""tpupose_torch.losses (the exports of tpupose/losses/__init__.py)."""

from tpupose_torch.losses.heatmap import joints_mse_loss
from tpupose_torch.losses.keypoint import (
    KPT_LOSSES, adaptive_wing_loss, get_kpt_loss, hybrid_keypoint_loss,
    multiscale_keypoint_loss, oks_loss, wing_loss,
)
from tpupose_torch.losses.classify import (
    binary_cross_entropy_with_logits, cross_entropy, focal_loss,
    multiclass_focal_loss, varifocal_loss,
)
from tpupose_torch.losses.bbox import (ciou, kpts_to_box, pairwise_iou_xyxy,
                                       xywh2xyxy, xyxy2xywh)
from tpupose_torch.losses.pose_loss import ComputeLoss
from tpupose_torch.losses.assigner import TaskAlignedAssigner
from tpupose_torch.losses.v8 import (dfl_loss, v8ClassificationLoss,
                                     v8DetectionLoss, v8PoseLoss)

__all__ = [
    "joints_mse_loss",
    "KPT_LOSSES", "get_kpt_loss", "oks_loss", "wing_loss",
    "adaptive_wing_loss", "multiscale_keypoint_loss", "hybrid_keypoint_loss",
    "binary_cross_entropy_with_logits", "cross_entropy", "focal_loss",
    "multiclass_focal_loss", "varifocal_loss",
    "ciou", "kpts_to_box", "pairwise_iou_xyxy", "xywh2xyxy", "xyxy2xywh",
    "ComputeLoss", "TaskAlignedAssigner",
    "dfl_loss", "v8ClassificationLoss", "v8DetectionLoss", "v8PoseLoss",
]
