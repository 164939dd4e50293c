"""Builder: config -> objects, for the heatmap family (counterpart of
tpupose/engine/builder.py).

Ported: `model()` (simple_baseline, hrnet, vitpose), `loss()` (joints_mse,
joints_mse_weighted), `lr_scheduler()`, `optimizer()` (head/base lr
split, frozen backbone, global-norm clipping), `dataset()` (synthetic,
coco) and `dataloader()`. Any other name raises ValueError naming the ROADMAP
item that ports it. The JAX package's `set_device` (a device mesh) has
no counterpart yet: the port trains on one device.
"""

from __future__ import annotations

import torch

from tpupose_torch._device import resolve_device
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.schedulers import make_schedule


def is_backbone_path(name: str) -> bool:
    """Parameter-name predicate for the two-group lr split and freezing:
    the backbone's parameters are `backbone.*` in the port's models (the
    JAX package's `ResNet_0/...`, `HRNet_0/...`, `DinoViT_0/...`)."""
    return name.startswith("backbone.")


_MODEL_ITEMS = {"dinov3_pose": "Queue A item 8",
                "simcc": "Queue A item 9", "deeppose": "Queue A item 9",
                "bottom_up": "Queue A item 9", "fskd": "Queue A item 10",
                "fcmae": "Queue A item 10"}


def _unported(kind: str, name: str, item: str):
    return ValueError(f"{kind} {name!r} is not ported to tpupose_torch yet "
                      f"(ROADMAP {item})")


class Builder:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- model -----------------------------------------------------------------
    def model(self):
        """SimpleBaseline, HRNetPose or ViTPose with flax's default init
        drawn from a generator seeded by train.seed, float32 master
        weights, and bf16 autocast when train.mixed_precision (else
        float32 throughout). train.remat checkpoints the blocks
        (models/remat.py; ViTPose's through its own DinoViT)."""
        from tpupose_torch.models import MODELS
        from tpupose_torch.models.simple_baseline import init_like_flax

        m = self.cfg.model
        if m.name not in MODELS:
            raise _unported("model", m.name, _MODEL_ITEMS.get(
                m.name, "Queue A items 8-10"))
        if m.pretrained:
            raise _unported("model.pretrained", m.pretrained,
                            "Queue A item 12")
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

    # -- loss ------------------------------------------------------------------
    def loss(self):
        from tpupose_torch.losses.heatmap import (joints_mse_loss,
                                                  joints_mse_weighted_loss)

        name = self.cfg.loss.name
        if name == "joints_mse":
            utw = self.cfg.loss.use_target_weight

            def fn(pred, target, target_weight=None):
                return joints_mse_loss(pred, target, target_weight, utw)

            return fn
        if name == "joints_mse_weighted":
            return joints_mse_weighted_loss
        raise _unported("loss", name, "Queue A items 8-9")

    # -- optimizer + schedule --------------------------------------------------
    def lr_scheduler(self, steps_per_epoch: int):
        """(base, head) lr(t) functions; warmup and decay in update units."""
        t = self.cfg.train
        upd_per_epoch = max(1, steps_per_epoch)
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
        if d.name != "synthetic":
            raise _unported("dataset", d.name, "Queue A item 12")
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
