"""Trainer: the epoch loop for the heatmap family, SimpleBaseline and
ViTPose (counterpart of tpupose/engine/trainer.py).

Ported: construction (builder, datasets and loaders, model, optimizer
with per-group schedules, EMA, the train and eval steps, log file,
tensorboard scalars, checkpoints), device prefetch of prepared batches,
`iter_one_epoch` (img/s over the epoch, host sync only at the logged
steps), loss-only `validate` (pad-mask weighting, EMA weights), `train`
with the SIGTERM/SIGINT checkpoint guard, `save_checkpoint` and
`load_checkpoint`. Not ported yet (ROADMAP Queue A): the other families,
distillation, pretrained weights, the device mesh, and the metric
`evaluate()` (so `eval.run_metrics` raises).

Runs on `device` (default "cuda"; raises where CUDA is absent). On the
card a ViTPose step runs the flash-attention kernels K8 (forward) and K8b
(backward) in every block; `train.remat` recomputes each block, K8
included, in the backward.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time

import numpy as np
import torch

from tpupose_torch._device import resolve_device
from tpupose_torch.data.loader import prefetch_to_device, to_device
from tpupose_torch.engine.builder import Builder
from tpupose_torch.engine.checkpoint import CheckpointManager, restore_path
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_eval_step,
                                              make_heatmap_train_step)
from tpupose_torch.ops.heatmap import gaussian_heatmaps
from tpupose_torch.utils.logging import FileLogger, printM, printS, printT, printW
from tpupose_torch.utils.meters import MetricDict
from tpupose_torch.utils.seed import set_seed
from tpupose_torch.utils.tensorboard import SummaryWriter


class Trainer:
    def __init__(self, cfg, builder: Builder | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.builder = builder or Builder(cfg, self.device)
        if cfg.train.distill_cfg:
            raise ValueError("distillation (train.distill_cfg) is not ported "
                             "to tpupose_torch yet (ROADMAP Queue A item 5)")
        if cfg.eval.run_metrics:
            raise ValueError("metric evaluation (eval.run_metrics) is not "
                             "ported to tpupose_torch yet (ROADMAP Queue A "
                             "item 4)")
        if cfg.loss.name not in ("joints_mse", "joints_mse_weighted"):
            raise ValueError(f"the port trains the heatmap family only; loss "
                             f"{cfg.loss.name!r} waits (ROADMAP Queue A "
                             f"items 8-9)")
        self.family = "heatmap"
        set_seed(cfg.train.seed, cfg.train.deterministic)

        self.model = self.builder.model()
        self.train_ds = self.builder.dataset("train")
        self.valid_ds = self.builder.dataset("valid")
        self.train_loader = self.builder.dataloader(self.train_ds, "train")
        self.valid_loader = self.builder.dataloader(self.valid_ds, "valid")
        self.steps_per_epoch = max(len(self.train_loader), 1)

        opt = self.builder.optimizer(self.model, self.steps_per_epoch)
        self.state = TrainState(self.model, opt,
                                ema_decay=cfg.train.ema_decay)
        self.loss_fn = self.builder.loss()
        dev_aff = cfg.data.device_affine
        self.train_step = make_heatmap_train_step(
            self.loss_fn,
            color_jitter_strength=cfg.data.color_jitter,
            jitter_seed=cfg.train.seed,
            heatmap_size=tuple(cfg.model.heatmap_size),
            sigma=cfg.data.sigma,
            affine_rotation=cfg.data.rotation_factor if dev_aff else 0.0,
            affine_scale=cfg.data.scale_factor if dev_aff else 0.0,
            udp=cfg.data.udp)
        self.eval_step = make_heatmap_eval_step()
        self.img_per_s = float("nan")       # the last epoch's figure

        exp_dir = os.path.join(cfg.train.output_dir, cfg.train.experiment)
        self.file_log = FileLogger(os.path.join(exp_dir, "log.txt"))
        self.tb = SummaryWriter(os.path.join(exp_dir, "tb")
                                if cfg.train.tensorboard else "")
        self.ckpt = CheckpointManager(os.path.join(exp_dir, "ckpt"),
                                      interval=cfg.train.ckpt_interval)
        self._exit_signal = None
        if cfg.model.checkpoint:
            self.load_checkpoint(cfg.model.checkpoint)

    # ------------------------------------------------------------------
    def _prefetched(self, loader, depth: int = 2):
        """Prepared batches on the device, `depth` ahead of the step
        (pinned host memory, non_blocking copies)."""
        yield from prefetch_to_device(
            ({k: b[k] for k in ("images", "joints", "visibility")}
             for b in loader), self.device, depth)

    def _prepare_batch(self, batch, for_eval: bool = False):
        """Host batch -> device batch. Training ships images + joints (the
        targets are rendered in the step); eval renders the targets
        here."""
        dev = to_device({k: batch[k] for k in ("images", "joints",
                                               "visibility")}, self.device)
        if not for_eval:
            return dev
        target, tw = gaussian_heatmaps(dev["joints"], dev["visibility"],
                                       tuple(self.cfg.model.heatmap_size),
                                       self.cfg.data.sigma)
        return {"images": dev["images"], "target": target.permute(0, 2, 3, 1),
                "target_weight": tw}

    def iter_one_epoch(self, epoch: int) -> float:
        """One pass over the train loader. Metrics reach the host only at
        logged steps (the first, every log_interval-th, and the last), as
        in the JAX trainer, whose epoch mean is over those steps."""
        meters = MetricDict()
        t0 = time.perf_counter()
        n_img = 0
        metrics = None
        logged = True
        for step, db in enumerate(self._prefetched(self.train_loader)):
            metrics = self.train_step(self.state, db)
            self._check_exit_signal()
            n_img += db["images"].shape[0]
            logged = ((step + 1) % self.cfg.train.log_interval == 0
                      or step == 0)
            if logged:
                m = {k: float(v) for k, v in metrics.items()}
                meters.update(m)
                printT(f"epoch {epoch} step {step + 1}/{self.steps_per_epoch}"
                       f" loss={m['loss']:.5f} gnorm={m['grad_norm']:.3f}")
                self.tb.add_scalars(m, self.state.step, prefix="train/")
        if metrics is not None and not logged:
            meters.update({k: float(v) for k, v in metrics.items()})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.img_per_s = n_img / max(dt, 1e-9)
        msg = f"epoch {epoch}: {meters.format()} ({self.img_per_s:.1f} img/s)"
        printM(msg)
        self.file_log.log(msg)
        self.tb.add_scalar("train/img_per_s", self.img_per_s, self.state.step)
        return meters["loss"].avg if "loss" in meters._meters \
            else float("inf")

    def validate(self) -> float:
        """Loss-only validation on the eval weights (the EMA when
        tracked). The padded tail batch's duplicate rows get zero target
        weight, and batches are combined weighted by their real rows."""
        total, n = 0.0, 0
        model = self.state.for_eval()
        for batch in self.valid_loader:
            pm = batch.get("pad_mask")
            db = self._prepare_batch(batch, for_eval=True)
            n_real = int(pm.sum()) if pm is not None else len(batch["images"])
            if pm is not None and not bool(pm.all()):
                m = torch.from_numpy(pm.astype(np.float32)).to(self.device)
                db["target_weight"] = db["target_weight"] * m[:, None]
            preds = self.eval_step(model, db["images"])
            loss = self.loss_fn(preds, db["target"], db["target_weight"])
            total += float(loss) * n_real
            n += n_real
        if n == 0:
            printW("validation loader produced no batches")
            return float("nan")
        return total / n

    def train(self):
        start_epoch = self.state.step // self.steps_per_epoch
        with self._checkpoint_on_signal():
            self._train_epochs(start_epoch, self.cfg.train.epochs)

    def _checkpoint_on_signal(self):
        """SIGTERM/SIGINT during train() sets a flag; the loop saves a
        resumable checkpoint at the next step boundary and exits (a second
        signal exits at once)."""

        @contextlib.contextmanager
        def guard():
            def handler(signum, frame):
                if self._exit_signal is not None:
                    raise SystemExit(128 + signum)
                self._exit_signal = signum
                printM(f"signal {signum}: will checkpoint at the next "
                       f"step boundary (signal again to force exit)")

            self._exit_signal = None
            prev = {}
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev[sig] = signal.signal(sig, handler)
                except (ValueError, OSError):        # not the main thread
                    pass
            try:
                yield
            finally:
                for sig, old in prev.items():
                    signal.signal(sig, old)

        return guard()

    def _check_exit_signal(self):
        sig = self._exit_signal
        if sig is not None:
            printM(f"signal {sig}: saving checkpoint @ step "
                   f"{self.state.step} before exit")
            self.ckpt.save(self.state.step, self.state, force=True)
            raise SystemExit(128 + sig)

    def _train_epochs(self, start_epoch: int, epochs: int):
        for epoch in range(start_epoch, epochs):
            train_loss = self.iter_one_epoch(epoch)
            self._check_exit_signal()
            if (epoch + 1) % self.cfg.eval.interval == 0:
                val_loss = self.validate()
                printM(f"epoch {epoch}: val_loss={val_loss:.5f}")
                self.file_log.log(f"epoch {epoch}: val_loss={val_loss:.5f}")
                self.tb.add_scalar("val/loss", val_loss, self.state.step)
            self.ckpt.save(self.state.step, self.state, metric=train_loss,
                           epoch=epoch)
        self.ckpt.save(self.state.step, self.state, force=True)
        self.tb.close()
        printS("training complete")

    # ------------------------------------------------------------------
    def save_checkpoint(self, metric: float | None = None):
        self.ckpt.save(self.state.step, self.state, metric=metric, force=True)

    def load_checkpoint(self, path: str | None = None):
        """Restore the latest periodic checkpoint of this experiment, its
        best slot (`"@best"`), or a checkpoint directory `path`
        (`"<dir>"` or `"<dir>@best"`). Returns the restored step."""
        best = bool(path) and path.endswith("@best")
        dirpath = path[: -len("@best")] if best else path
        if dirpath:
            if not os.path.isdir(dirpath):
                raise FileNotFoundError(
                    f"model.checkpoint points at {dirpath!r}, which is not "
                    f"a directory")
            _, step = restore_path(self.state, path)
        else:
            _, step = self.ckpt.restore(self.state, best=best)
        return step
