"""Episodic (FSKD) and masked-autoencoder (FCMAE) training loops
(counterpart of tpupose/engine/episodic_trainer.py).

`EpisodicTrainer(cfg, base_dataset=None, device="cuda")`: N-way/K-shot
episodes (data/episodic.FewShotDataset on the base dataset, by default
`_synthetic_class_dataset`), the FSKD model of Builder.model() (ViT size
from model.backbone, dim 256), one update per episode: forward on the
support and query images (/255, no mean/std, as JAX's `_to_device`),
`fskd_episode_loss` on the queries, backward, the optimizer of
make_optimizer (every parameter in one group, at make_schedule's lr over
epochs x episodes_per_epoch steps). Like JAX's constructor it draws the
first episode once before training (JAX initialises the model on it), so
the episodes of a run are JAX's, bit for bit.

`MAETrainer(cfg, dataset=None, device="cuda")`: FCMAE pretraining
(ConvNeXtV2 size from model.backbone) over BatchLoader batches of the
dataset (by default 256 synthetic top-down crops), each step's patch
mask drawn from the trainer's own torch.Generator seeded by train.seed.

Both run under bf16 autocast over float32 masters with
train.mixed_precision, else float32 throughout (on the card FSKD's ViT
then raises: K8 and K8b are bf16, as for ViTPose). Both save a checkpoint
each epoch (engine/checkpoint.CheckpointManager, the epoch's mean loss as
its metric). On the card an FSKD step launches K8 2 x depth times in the
forward (support and query encodes) and K8b as often in the backward;
FCMAE runs no hand kernel.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpupose_torch._device import resolve_device
from tpupose_torch.engine.builder import Builder
from tpupose_torch.engine.checkpoint import CheckpointManager
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.schedulers import make_schedule
from tpupose_torch.engine.train_state import TrainState
from tpupose_torch.utils.logging import printM, printS
from tpupose_torch.utils.meters import MetricDict
from tpupose_torch.utils.seed import set_seed

_EPISODE_KEYS = ("support_images", "support_labels", "query_images",
                 "query_labels", "query_keypoints", "query_visibility")


def _state(cfg, model, steps: int, warmup_steps: int) -> TrainState:
    sched = make_schedule(cfg.lr_scheduler, cfg.optimizer.lr, steps,
                          warmup_steps)
    opt = make_optimizer(cfg.optimizer, model.named_parameters(),
                         schedule=sched,
                         grad_clip_norm=cfg.train.grad_clip_norm)
    return TrainState(model, opt)


def _ckpt(cfg) -> CheckpointManager:
    return CheckpointManager(
        os.path.join(cfg.train.output_dir, cfg.train.experiment, "ckpt"),
        interval=cfg.train.ckpt_interval)


class EpisodicTrainer:
    """N-way/K-shot episodic training of FSKD."""

    def __init__(self, cfg, base_dataset=None, device="cuda"):
        from tpupose_torch.data.episodic import FewShotDataset

        self.cfg = cfg
        self.device = resolve_device(device)
        set_seed(cfg.train.seed)
        d = cfg.data
        if base_dataset is None:
            base_dataset = _synthetic_class_dataset(
                num_classes=max(d.n_way + 2, 6),
                num_keypoints=cfg.model.num_keypoints,
                image_size=tuple(d.image_size))
        self.episodes = FewShotDataset(
            base_dataset, n_way=d.n_way, k_shot=d.k_shot, n_query=d.n_query,
            episodes_per_epoch=d.episodes_per_epoch, seed=cfg.train.seed)
        _ = self.episodes[0]      # JAX's init episode: keeps its draw order
        self.model = Builder(cfg, self.device).model().train()
        self.state = _state(cfg, self.model,
                            cfg.train.epochs * d.episodes_per_epoch,
                            cfg.train.warmup_epochs * d.episodes_per_epoch)
        self.ckpt = _ckpt(cfg)

    def to_device(self, ep: dict) -> dict:
        """A host episode -> device tensors; images uint8 -> float32 / 255."""
        out = {k: torch.from_numpy(np.ascontiguousarray(ep[k]))
               .to(self.device) for k in _EPISODE_KEYS}
        for k in ("support_images", "query_images"):
            out[k] = out[k].float() / 255.0
        return out

    def train_step(self, ep: dict) -> dict:
        """One update on a device episode; {"loss", "loss_cls",
        "loss_kpt", "loss_conf"} as device tensors."""
        from tpupose_torch.models.fskd import fskd_episode_loss

        self.state.optimizer.zero_grad()
        out = self.model(ep["support_images"], ep["support_labels"],
                         ep["query_images"])
        total, parts = fskd_episode_loss(out, ep["query_labels"],
                                         ep["query_keypoints"],
                                         ep["query_visibility"])
        total.backward()
        self.state.apply_gradients()
        return {"loss": total.detach(),
                **{f"loss_{k}": v.detach() for k, v in parts.items()}}

    def train(self) -> float:
        """Every epoch; returns the last epoch's mean logged loss."""
        meters = MetricDict()
        log_every = self.cfg.train.log_interval
        for epoch in range(self.cfg.train.epochs):
            meters.reset()
            t0 = time.perf_counter()
            for i in range(len(self.episodes)):
                m = self.train_step(self.to_device(self.episodes[i]))
                if (i + 1) % log_every == 0:
                    meters.update(m)
            meters.update(m)
            printM(f"episodic epoch {epoch}: {meters.format()} "
                   f"({len(self.episodes) / (time.perf_counter() - t0):.1f}"
                   f" ep/s)")
            self.ckpt.save(self.state.step, self.state,
                           metric=meters["loss"].avg)
        printS("episodic training complete")
        return meters["loss"].avg


class MAETrainer:
    """FCMAE masked-autoencoder pretraining."""

    def __init__(self, cfg, dataset=None, device="cuda"):
        from tpupose_torch.data.loader import BatchLoader

        self.cfg = cfg
        self.device = resolve_device(device)
        set_seed(cfg.train.seed)
        if dataset is None:
            from tpupose_torch.data.synthetic import SyntheticTopDownDataset

            dataset = SyntheticTopDownDataset(
                num_samples=256, image_size=tuple(cfg.data.image_size),
                num_keypoints=cfg.model.num_keypoints)
        self.loader = BatchLoader(dataset, cfg.train.batch_size,
                                  seed=cfg.train.seed)
        self.model = Builder(cfg, self.device).model().train()
        n = max(len(self.loader), 1)
        self.state = _state(cfg, self.model, cfg.train.epochs * n,
                            cfg.train.warmup_epochs * n)
        self.mask_rng = torch.Generator(device=self.device) \
            .manual_seed(cfg.train.seed)
        self.ckpt = _ckpt(cfg)

    def train_step(self, images: torch.Tensor) -> torch.Tensor:
        """One update on uint8 (B, H, W, 3) device images, a fresh mask
        from the trainer's generator; the loss as a device tensor."""
        self.state.optimizer.zero_grad()
        loss, _ = self.model(images.float() / 255.0,
                             generator=self.mask_rng)
        loss.backward()
        self.state.apply_gradients()
        return loss.detach()

    def train(self) -> float:
        """Every epoch; returns the last epoch's mean loss."""
        last = float("inf")
        for epoch in range(self.cfg.train.epochs):
            total, n = 0.0, 0
            for batch in self.loader:
                imgs = torch.from_numpy(batch["images"]).to(self.device)
                total += float(self.train_step(imgs))
                n += 1
            last = total / max(n, 1)
            printM(f"fcmae epoch {epoch}: loss={last:.5f}")
            self.ckpt.save(self.state.step, self.state, metric=last)
        printS("fcmae pretraining complete")
        return last


def _synthetic_class_dataset(num_classes: int, num_keypoints: int,
                             image_size=(32, 32), per_class: int = 12,
                             seed: int = 0):
    """A labeled base dataset for episodic smoke training: a per-class
    intensity, noise, and random keypoints (JAX's draws, in its order)."""
    rng = np.random.RandomState(seed)
    H, W = image_size

    class _DS:
        def __init__(self):
            self.samples = []
            for c in range(num_classes):
                for _ in range(per_class):
                    img = np.full((H, W, 3),
                                  int(255 * (c + 1) / (num_classes + 1)),
                                  np.uint8)
                    img = np.clip(img + rng.randint(-10, 10, img.shape),
                                  0, 255).astype(np.uint8)
                    kp = rng.uniform(0.2, 0.8,
                                     (num_keypoints, 3)).astype(np.float32)
                    kp[:, 2] = 2.0
                    self.samples.append({"class_id": c, "image": img,
                                         "keypoints": kp})

        def __len__(self):
            return len(self.samples)

        def __getitem__(self, i):
            return self.samples[i]

    return _DS()
