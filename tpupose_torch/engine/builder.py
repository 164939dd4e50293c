"""Builder: config -> objects (counterpart of tpupose/engine/builder.py).

Ported: `model()` (simple_baseline, hrnet, vitpose, dinov3_pose, simcc,
deeppose, bottom_up, fskd, fcmae), `loss()` (joints_mse, joints_mse_weighted,
DINOv3Pose's pose_compute and v8_pose, coord_mse, rle, ae, simcc_kl),
`lr_scheduler()`, `optimizer()` (head/base lr
split, frozen backbone, global-norm clipping), `dataset()` (synthetic,
synthetic_yolo, coco) and `dataloader()`. Any other
name raises ValueError naming the ROADMAP item that ports it. The JAX
package's `set_device` (a device mesh) has no counterpart yet: the port
trains on one device.
"""

from __future__ import annotations

import functools

import torch

from tpupose_torch._device import resolve_device
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.schedulers import make_schedule


def is_backbone_path(name: str) -> bool:
    """Parameter-name predicate for the two-group lr split and freezing:
    the backbone's parameters are `backbone.*` in the port's models (the
    JAX package's `ResNet_0/...`, `HRNet_0/...`, `DinoViT_0/...`)."""
    return name.startswith("backbone.")


def _unported(kind: str, name: str, item: str):
    return ValueError(f"{kind} {name!r} is not ported to tpupose_torch yet "
                      f"(ROADMAP {item})")


class Builder:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- model -----------------------------------------------------------------
    def model(self):
        """SimpleBaseline, HRNetPose, ViTPose, DINOv3Pose, SimCCPose,
        DeepPose (RLE head with loss.name "rle"), BottomUpPose, FSKD (n_way
        from data.n_way, dim 256, the ViT size after "vit_" in
        model.backbone, else small, as JAX's EpisodicTrainer builds it) or
        FCMAE (the ConvNeXt size after "convnext_", else atto, as JAX's
        MAETrainer) with flax's init drawn from a generator seeded by
        train.seed, float32 master weights, and bf16 autocast when
        train.mixed_precision (else float32 throughout). train.remat
        checkpoints the blocks (models/remat.py; ViTPose's through its own
        DinoViT)."""
        from tpupose_torch.models import MODELS
        from tpupose_torch.models.simple_baseline import init_like_flax

        m = self.cfg.model
        if m.name not in MODELS:
            raise ValueError(f"unknown model {m.name!r}; have "
                             f"{sorted(MODELS)}")
        remat = self.cfg.train.remat
        dtype = (torch.bfloat16 if self.cfg.train.mixed_precision
                 else torch.float32)
        g = torch.Generator().manual_seed(self.cfg.train.seed)
        if m.name == "vitpose":
            from tpupose_torch.models.vitpose import (ViTPose,
                                                      init_vitpose_like_flax)

            model = ViTPose(m.backbone, m.num_keypoints, m.decoder,
                            tuple(m.deconv_channels)[:2],
                            freeze_backbone=m.freeze_backbone, dtype=dtype,
                            device="cpu", param_dtype=torch.float32,
                            remat=remat)
            init_vitpose_like_flax(model, g)
        elif m.name == "dinov3_pose":
            from tpupose_torch.models.dinov3_pose import (
                DINOv3Pose, init_dinov3_pose_like_flax)

            model = DINOv3Pose(m.backbone, m.num_keypoints, m.num_classes,
                               tuple(m.neck_channels), tuple(m.strides),
                               freeze_backbone=m.freeze_backbone,
                               reg_max=self._reg_max(), dtype=dtype,
                               device="cpu", param_dtype=torch.float32,
                               remat=remat)
            init_dinov3_pose_like_flax(model, g)
        elif m.name == "deeppose":
            from tpupose_torch.models.deeppose import (
                DeepPose, init_deeppose_like_flax)

            # loss rle implies the (mu, sigma) + flow head: the loss and
            # the head agree (the v8_pose / reg_max coupling)
            model = DeepPose(m.backbone, m.num_keypoints,
                             rle=(self.cfg.loss.name == "rle"), dtype=dtype,
                             device="cpu", param_dtype=torch.float32,
                             remat=remat)
            init_deeppose_like_flax(model, g)
        elif m.name == "simcc":
            from tpupose_torch.models.simcc import SimCCPose

            # the bin grid doubles as model.heatmap_size (the joint
            # transform and the evaluator's back-projection are shared)
            H, W = self.cfg.data.image_size
            r = m.split_ratio
            want = (int(H * r), int(W * r))
            if tuple(m.heatmap_size) != want:
                raise ValueError(
                    f"simcc: model.heatmap_size must equal image_size x "
                    f"split_ratio = {want}, got {tuple(m.heatmap_size)}")
            model = SimCCPose(m.backbone, m.num_keypoints, r, (H, W),
                              dtype=dtype, device="cpu",
                              param_dtype=torch.float32, remat=remat)
            init_like_flax(model, g)
        elif m.name == "bottom_up":
            from tpupose_torch.models.bottom_up import BottomUpPose

            model = BottomUpPose(m.backbone, m.num_keypoints,
                                 tuple(m.deconv_channels), dtype=dtype,
                                 device="cpu", param_dtype=torch.float32,
                                 remat=remat)
            init_like_flax(model, g)
        elif m.name == "fskd":
            from tpupose_torch.models.fskd import FSKD, init_fskd_like_flax

            size = m.backbone.replace("vit_", "") \
                if m.backbone.startswith("vit") else "small"
            model = FSKD(n_way=self.cfg.data.n_way,
                         num_keypoints=m.num_keypoints, dim=256,
                         vit_size=size, dtype=dtype, device="cpu",
                         param_dtype=torch.float32)
            init_fskd_like_flax(model, g)
        elif m.name == "fcmae":
            from tpupose_torch.models.fcmae import FCMAE, init_fcmae_like_flax

            size = m.backbone.replace("convnext_", "") \
                if "convnext" in m.backbone else "atto"
            model = FCMAE(size=size, dtype=dtype, device="cpu",
                          param_dtype=torch.float32)
            init_fcmae_like_flax(model, g)
        elif m.name == "hrnet":
            from tpupose_torch.models.backbones.hrnet import HRNetPose

            model = HRNetPose(m.backbone, m.num_keypoints, dtype=dtype,
                              device="cpu", param_dtype=torch.float32,
                              remat=remat)
            init_like_flax(model, g)
        else:
            from tpupose_torch.models.simple_baseline import SimpleBaseline

            model = SimpleBaseline(m.backbone, m.num_keypoints,
                                   tuple(m.deconv_channels), dtype=dtype,
                                   device="cpu", param_dtype=torch.float32,
                                   remat=remat)
            init_like_flax(model, g)
        return model.to(self.device)

    def _reg_max(self) -> int:
        """The v8_pose loss needs the head's DFL box branch: loss and head
        agree on one reg_max (16 unless the config sets one)."""
        if self.cfg.loss.name == "v8_pose":
            return self.cfg.model.reg_max or 16
        return self.cfg.model.reg_max

    # -- loss ------------------------------------------------------------------
    def loss(self):
        from tpupose_torch.losses.heatmap import (joints_mse_loss,
                                                  joints_mse_weighted_loss)

        name = self.cfg.loss.name
        lc, m = self.cfg.loss, self.cfg.model
        if name == "pose_compute":
            from tpupose_torch.losses.pose_loss import ComputeLoss

            return ComputeLoss(num_keypoints=m.num_keypoints,
                               num_classes=m.num_classes,
                               strides=tuple(m.strides),
                               kpt_loss_type=lc.kpt_loss_type,
                               cls_weight=lc.cls_weight,
                               kpt_weight=lc.kpt_weight,
                               vis_weight=lc.vis_weight)
        if name == "v8_pose":
            from tpupose_torch.losses.v8 import v8PoseLoss

            return v8PoseLoss(num_keypoints=m.num_keypoints,
                              num_classes=m.num_classes,
                              strides=tuple(m.strides),
                              reg_max=self._reg_max())
        if name == "joints_mse":
            utw = self.cfg.loss.use_target_weight

            def fn(pred, target, target_weight=None):
                return joints_mse_loss(pred, target, target_weight, utw)

            return fn
        if name == "joints_mse_weighted":
            return joints_mse_weighted_loss
        if name == "coord_mse":
            from tpupose_torch.losses.heatmap import coord_mse_loss

            return coord_mse_loss
        if name == "rle":
            from tpupose_torch.losses.rle import rle_loss

            return functools.partial(rle_loss, residual=lc.rle_residual,
                                     q=lc.rle_q)
        if name == "ae":
            from tpupose_torch.losses.ae import ae_loss

            return functools.partial(ae_loss, sigma=self.cfg.data.sigma,
                                     tag_sigma=lc.ae_tag_sigma,
                                     pull_weight=lc.ae_pull_weight,
                                     push_weight=lc.ae_push_weight)
        if name == "simcc_kl":
            from tpupose_torch.losses.simcc import simcc_kl_loss

            return simcc_kl_loss
        raise ValueError(f"unknown loss {name!r}")

    # -- optimizer + schedule --------------------------------------------------
    def lr_scheduler(self, steps_per_epoch: int):
        """(base, head) lr(t) functions; warmup and decay in update units:
        with grad_accum_steps k an update is k train steps."""
        t = self.cfg.train
        upd_per_epoch = max(1, steps_per_epoch // max(1, t.grad_accum_steps))
        total = t.epochs * upd_per_epoch
        warmup = t.warmup_epochs * upd_per_epoch
        base = make_schedule(self.cfg.lr_scheduler, self.cfg.optimizer.lr,
                             total, warmup, upd_per_epoch)
        head = make_schedule(self.cfg.lr_scheduler,
                             self.cfg.optimizer.head_lr, total, warmup,
                             upd_per_epoch)
        return base, head

    def optimizer(self, model, steps_per_epoch: int):
        """Every non-backbone parameter trains at head_lr, the backbone at
        lr (or not at all with model.freeze_backbone)."""
        base, head = self.lr_scheduler(steps_per_epoch)
        is_frozen = is_backbone_path if self.cfg.model.freeze_backbone \
            else None
        return make_optimizer(self.cfg.optimizer, model.named_parameters(),
                              schedule=base, head_schedule=head,
                              is_head=lambda n: not is_backbone_path(n),
                              is_frozen=is_frozen,
                              grad_clip_norm=self.cfg.train.grad_clip_norm,
                              grad_accum_steps=self.cfg.train.grad_accum_steps)

    # -- data ------------------------------------------------------------------
    def dataset(self, split: str = "train"):
        d = self.cfg.data
        if d.name == "coco":
            from tpupose_torch.data.coco import CocoTopDownDataset

            return CocoTopDownDataset.from_config(self.cfg, split)
        if d.name == "synthetic_yolo":
            from tpupose_torch.data.synthetic import SyntheticYoloPoseDataset

            # both splits on the dataset's default seed 0, as in JAX
            return SyntheticYoloPoseDataset(
                num_samples=128 if split == "train" else 32,
                image_size=tuple(d.image_size),
                num_keypoints=self.cfg.model.num_keypoints,
                num_classes=self.cfg.model.num_classes,
                max_instances=d.max_instances)
        if d.name != "synthetic":
            raise _unported("dataset", d.name, "Queue A item 12b")
        from tpupose_torch.data.synthetic import SyntheticTopDownDataset

        n = 256 if split == "train" else 64
        return SyntheticTopDownDataset(
            num_samples=n, image_size=tuple(d.image_size),
            heatmap_size=tuple(self.cfg.model.heatmap_size),
            num_keypoints=self.cfg.model.num_keypoints,
            seed=0 if split == "train" else 1)

    def dataloader(self, dataset, split: str = "train"):
        from tpupose_torch.data.loader import BatchLoader

        bs = (self.cfg.train.batch_size if split == "train"
              else self.cfg.eval.batch_size)
        bs = min(bs, len(dataset)) if len(dataset) else bs
        # eval keeps every sample and pads the tail batch (pad_mask)
        return BatchLoader(dataset, batch_size=bs, shuffle=(split == "train"),
                           drop_last=(split == "train"),
                           seed=self.cfg.train.seed,
                           num_workers=self.cfg.data.num_workers,
                           pad_last=(split != "train"))
