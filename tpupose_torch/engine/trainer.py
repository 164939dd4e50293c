"""Trainer: the epoch loop for the heatmap family, SimpleBaseline, HRNet
and ViTPose (counterpart of tpupose/engine/trainer.py).

Ported: construction (builder, datasets and loaders, model, optimizer
with per-group schedules, EMA, the train and eval steps, log file,
tensorboard scalars, checkpoints), device prefetch of prepared batches,
`iter_one_epoch` (img/s over the epoch, host sync only at the logged
steps), loss-only `validate` (pad-mask weighting, EMA weights), metric
`evaluate` (flip test + DARK + back-projection + the metrics of
`eval.metrics` over the valid set, `eval.dump_results`; in the epoch
loop with `eval.run_metrics`; int8 evaluation with `eval.int8`, the PTQ
intercept, and `eval.int8_engine`, cli.serve's int8 engine (the R50's
CudaServingEngine, else Int8Engine), both calibrated on the first
validation batch against the current eval weights at every
call), `train` with the SIGTERM/SIGINT checkpoint guard,
`save_checkpoint` and `load_checkpoint`. Not ported yet (ROADMAP Queue
A): the other families, distillation, pretrained weights, the device
mesh and detection-box evaluation (`eval.det_boxes`).

Runs on `device` (default "cuda"; raises where CUDA is absent). On the
card a ViTPose step runs the flash-attention kernels K8 (forward) and K8b
(backward) in every block; `train.remat` recomputes each block, K8
included, in the backward. `evaluate` of a SimpleBaseline-R50 at
256x192 runs the stem (K1), layer1 (K2) and block2_0 (K3) kernels on
weights folded from the current (EMA where tracked) parameters at each
call, and the DARK decode kernel (K4).
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
            self._check_eval_options()
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
        self._evaluator = None              # built by the first evaluate()

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

    def _check_eval_options(self):
        """The evaluation options that are not ported yet raise."""
        e = self.cfg.eval
        if e.det_boxes:
            raise ValueError("detection-box evaluation (eval.det_boxes) is "
                             "not ported to tpupose_torch yet (ROADMAP "
                             "Queue A item 11)")

    def _build_eval_metrics(self):
        """Metric objects from cfg.eval.metrics."""
        from tpupose_torch.metrics import METRICS

        out = []
        for name in self.cfg.eval.metrics:
            if name not in METRICS:
                raise ValueError(f"unknown eval metric {name!r}")
            if name == "pck":
                out.append(METRICS[name](alpha=0.2))
            elif name == "oks_ap":
                out.append(METRICS[name](num_classes=1))
            else:
                out.append(METRICS[name]())
        return out

    def _get_evaluator(self):
        """Build the evaluator once; at every call hand it the current eval
        weights (the EMA where tracked), from which it re-folds the kernel
        route's weights.

        With eval.int8 or eval.int8_engine the evaluator is rebuilt at
        every call, as in JAX: the activation scales are calibrated on
        the first validation batch against the current weights, so the
        scales of an earlier evaluation would clip later activations."""
        from tpupose_torch.engine.evaluator import TopDownEvaluator

        model = self.state.for_eval()
        e = self.cfg.eval
        if self._evaluator is None or e.int8 or e.int8_engine:
            quant_scales, engine = self._int8_routes(model)
            # flip pairs come from the dataset (COCO defines its own);
            # datasets without a joint-order convention flip unpaired
            pairs = getattr(self.valid_ds, "flip_pairs", None)
            if pairs is None and self.cfg.model.num_keypoints != 17:
                pairs = np.zeros((0, 2), np.int64)
            self._evaluator = TopDownEvaluator(
                model, tuple(self.cfg.model.heatmap_size),
                decode=self.cfg.eval.decode,
                flip_test=self.cfg.eval.flip_test, flip_pairs=pairs,
                blur_kernel=self.cfg.eval.blur_kernel,
                sigma=self.cfg.data.sigma, udp=self.cfg.data.udp,
                device=self.device, int8_engine=engine,
                quant_scales=quant_scales)
        else:
            self._evaluator.refresh(model)
        return self._evaluator

    def _int8_routes(self, model):
        """(quant_scales, engine) of eval.int8 and eval.int8_engine, each
        calibrated on the first validation batch against `model` (None
        where the option is off); the engine is cli.serve's
        (ops/int8_engine.build_int8_engine)."""
        e = self.cfg.eval
        if not (e.int8 or e.int8_engine):
            return None, None
        try:
            first = np.asarray(next(iter(self.valid_loader))["images"])
        except StopIteration:
            raise ValueError("eval.int8/int8_engine need at least one "
                             "validation batch for activation calibration")
        quant_scales = engine = None
        if e.int8:
            from tpupose_torch.engine.predictor import HeatmapPredictor

            quant_scales = HeatmapPredictor.calibrate_int8(model, first)
        if e.int8_engine:
            from tpupose_torch.ops.int8_engine import build_int8_engine

            engine = build_int8_engine(model, first, decode_method=e.decode,
                                       blur_kernel=e.blur_kernel,
                                       device=self.device)
        return quant_scales, engine

    def _eval_batches(self):
        """The valid loader with every batch carrying GT joints in source
        coords (synthetic sets store joints in heatmap coords only)."""
        from tpupose_torch.ops.affine import transform_preds

        hm_size = tuple(self.cfg.model.heatmap_size)
        for batch in self.valid_loader:
            if "joints_src" not in batch:
                batch = dict(batch)
                batch["joints_src"] = transform_preds(
                    torch.from_numpy(np.asarray(batch["joints"], np.float32)),
                    torch.from_numpy(np.asarray(batch["center"], np.float32)),
                    torch.from_numpy(np.asarray(batch["scale"], np.float32)),
                    hm_size, udp=self.cfg.data.udp).numpy()
            yield batch

    def evaluate(self) -> dict:
        """Metric evaluation for the heatmap family: flip test + DARK +
        back-projection + the metrics of eval.metrics (PCK, MPJPE, COCO
        OKS-AP, ...) over the valid set, on the eval weights; with
        eval.dump_results also the COCO keypoint-results JSON."""
        self._check_eval_options()
        ev = self._get_evaluator()
        out = ev.run(self._eval_batches(), self._build_eval_metrics(),
                     results_path=self.cfg.eval.dump_results or None)
        printM("eval: " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
        return out

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
                if self.cfg.eval.run_metrics:
                    metrics = self.evaluate()
                    self.file_log.log(
                        f"epoch {epoch}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                    self.tb.add_scalars(metrics, self.state.step,
                                        prefix="eval/")
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
