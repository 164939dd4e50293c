"""Trainer: the epoch loop (counterpart of tpupose/engine/trainer.py)
for every family the JAX package trains with its Trainer: heatmap
(SimpleBaseline, HRNet, ViTPose), single-stage YOLO-pose (DINOv3Pose),
SimCC, coordinate regression (DeepPose) and RLE, and bottom-up AE. The
family follows loss.name, as in JAX.

Ported: construction (builder, datasets and loaders, model, optimizer
with per-group schedules, EMA, the family's train and eval steps, log
file, tensorboard scalars, checkpoints), device prefetch of prepared
batches, `iter_one_epoch` (img/s over the epoch, host sync only at the
logged steps), loss-only `validate` (pad-mask weighting, EMA weights),
metric `evaluate` (heatmap and SimCC families: flip test + decode +
back-projection + the metrics of `eval.metrics` over the valid set,
`eval.dump_results`; in the epoch loop with `eval.run_metrics`, as for
bottom-up; with `eval.det_boxes` also the official COCO protocol on a
detector's boxes, `evaluate_detections`, under det_*; int8 evaluation
with `eval.int8`, the PTQ intercept, and
`eval.int8_engine` (heatmap family only), cli.serve's int8 engine (the
R50's CudaServingEngine, else Int8Engine), both calibrated on the first
validation batch against the current eval weights at every call; yolo
family: `val_loss` and `evaluate_yolo`, YoloPosePredictor + OKS-NMS +
OKS-AP; regression and RLE: `val_loss` and `evaluate_regression`, PCK,
PCKh (K > 9), MPJPE, AUC, EPE in source pixels; bottom-up:
`evaluate_bottom_up`, BottomUpPredictor's AE grouping + OKS-AP, with
`eval.int8`), heatmap distillation from a frozen teacher
(`train.distill_cfg`, `train.distill_ckpt`), `train` with the
SIGTERM/SIGINT checkpoint guard, `save_checkpoint` and
`load_checkpoint`, `train.profile_dir` (step 10 of epoch 0 under
torch.profiler, its chrome trace written there), pretrained backbone
weights (`model.pretrained`, a torch checkpoint loaded by
models/pretrained.load_pretrained and copied into the EMA), and data
parallelism: under torchrun (`cfg.mesh`, Builder.set_device) the
model's BatchNorms synchronise their statistics over the ranks
(parallel/sync_bn.py) and the steps run it through
DistributedDataParallel; train.batch_size is the global batch, each
rank loading its contiguous slice of it, and a step's random draws
(device affine, color jitter) are drawn for the global batch and sliced,
and the losses are normalised by their counts over the global batch
(the losses' `count`, MeshManager.loss_count), so the ranks together
take the step one process takes at the global batch (the yolo family's
mosaic mixes each rank's own images: with it the ranks' step is DDP's,
not one process's). EMA, checkpoints and logs come from rank 0;
every rank restores, evaluates and validates the whole valid set.
With mesh.model > 1 the ranks form a (data, model) mesh (parallel/
mesh.py): the model's wide Conv2d, ConvTranspose2d and Linear layers
keep their model rank's output channels and gather their outputs
(parallel/tensor_parallel.py, JAX's shard rule), the model ranks of one
data index load the same batch slice and draw the same values, and DDP,
the synchronised BatchNorms and the loss count run over the data group;
evaluation runs on a gathered, full copy of the eval weights (so the
R50's K1-K4 route), and checkpoints hold the one-process format. The
distillation teacher stays replicated.

Runs on `device` (default "cuda"; raises where CUDA is absent). On the
card a ViTPose step runs the flash-attention kernels K8 (forward) and K8b
(backward) in every block; `train.remat` recomputes each block, K8
included, in the backward. A DINOv3Pose step on a ViT backbone runs K8
in every block, and K8b too where `model.freeze_backbone` is off (a
frozen backbone runs without a graph). A heatmap or SimCC step with
`data.device_affine` runs the warp kernel K7 once (a distilled or
gradient-accumulating step too). `evaluate` of a
SimpleBaseline-R50 at 256x192 runs the stem (K1), layer1 (K2) and
block2_0 (K3) kernels on weights folded from the current (EMA where
tracked) parameters at each call, and the DARK decode kernel (K4).
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
from tpupose_torch.engine.train_state import (
    YOLO_TARGETS, TrainState, make_bottom_up_train_step,
    make_heatmap_eval_step, make_heatmap_train_step,
    make_regression_train_step, make_rle_train_step, make_simcc_train_step,
    make_yolo_train_step)
from tpupose_torch.models.remat import frozen_batch_stats
from tpupose_torch.ops.heatmap import gaussian_heatmaps
from tpupose_torch.ops.preprocess import normalize_images
from tpupose_torch.utils.logging import FileLogger, printM, printS, printT, printW
from tpupose_torch.utils.meters import MetricDict
from tpupose_torch.utils.seed import set_seed
from tpupose_torch.utils.tensorboard import SummaryWriter


# loss.name -> the family that trains with it (JAX's Trainer rule)
_FAMILIES = {"joints_mse": "heatmap", "joints_mse_weighted": "heatmap",
             "pose_compute": "yolo", "v8_pose": "yolo",
             "coord_mse": "regression", "rle": "rle", "simcc_kl": "simcc",
             "ae": "bottom_up"}


class Trainer:
    def __init__(self, cfg, builder: Builder | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.builder = builder or Builder(cfg, self.device)
        self.mesh_mgr = self.builder.set_device()
        if cfg.loss.name not in _FAMILIES:
            raise ValueError(f"unknown loss {cfg.loss.name!r}")
        self.family = _FAMILIES[cfg.loss.name]
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
        if cfg.model.pretrained:
            from tpupose_torch.models.pretrained import load_pretrained

            if load_pretrained(self.model, cfg.model.pretrained,
                               cfg.model.backbone) \
                    and self.state.ema is not None:
                with torch.no_grad():
                    torch._foreach_copy_(self.state.ema,
                                         list(self.model.parameters()))
        self.mesh_mgr.shard_state(self.state)
        if self.mesh_mgr.distributed:
            self._wrap_data_parallel()
        # under a process group the losses normalise by their counts over
        # the global batch
        count = self.mesh_mgr.loss_count()
        self.loss_fn = self.builder.loss(count)
        self.teacher = None                 # the heatmap family's, distilling
        dev_aff = cfg.data.device_affine
        aug = dict(color_jitter_strength=cfg.data.color_jitter,
                   jitter_seed=cfg.train.seed,
                   affine_rotation=cfg.data.rotation_factor if dev_aff
                   else 0.0,
                   affine_scale=cfg.data.scale_factor if dev_aff else 0.0,
                   udp=cfg.data.udp)
        if self.family == "yolo":
            self.train_step = make_yolo_train_step(
                self.loss_fn, mosaic_prob=cfg.data.mosaic_prob,
                mosaic_seed=cfg.train.seed)
        elif self.family == "simcc":
            self.train_step = make_simcc_train_step(
                self.loss_fn, bins_hw=tuple(cfg.model.heatmap_size),
                sigma=cfg.data.simcc_sigma, **aug)
        elif self.family == "regression":
            self.train_step = make_regression_train_step(self.loss_fn)
        elif self.family == "rle":
            self.train_step = make_rle_train_step(self.loss_fn)
        elif self.family == "bottom_up":
            self.train_step = make_bottom_up_train_step(self.loss_fn)
        else:
            if cfg.train.distill_cfg:
                self.teacher = self._build_teacher()
            self.train_step = make_heatmap_train_step(
                self.loss_fn, heatmap_size=tuple(cfg.model.heatmap_size),
                sigma=cfg.data.sigma, teacher=self.teacher,
                distill_weight=cfg.train.distill_weight, count=count, **aug)
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

    def _wrap_data_parallel(self):
        """Data parallelism over the data group: the model's BatchNorms
        become SyncBatchNorm2d (global-batch statistics, as under JAX's
        jit sharding), and the train steps run it through
        DistributedDataParallel, whose backward averages the gradients
        over the data ranks, so the clip and the update see the global
        gradient. Buffers are not broadcast (the synchronised statistics
        are equal on every rank), and a parameter a step leaves unused (a
        frozen backbone, a branch the family does not run) is allowed."""
        from torch.nn.parallel import DistributedDataParallel

        from tpupose_torch.parallel.sync_bn import convert_sync_batchnorm

        mm = self.mesh_mgr
        convert_sync_batchnorm(self.model, mm.data_group)
        dev = self.device
        if dev.type == "cuda":
            ids = [dev.index if dev.index is not None
                   else torch.cuda.current_device()]
        else:
            ids = None
        self.state.ddp = DistributedDataParallel(
            self.model, device_ids=ids, process_group=mm.data_group,
            broadcast_buffers=False, find_unused_parameters=True)
        self.state.dp_rank, self.state.dp_world = mm.data_rank, mm.data_size
        self.state.dp_group = mm.data_group

    def _build_teacher(self) -> torch.nn.Module:
        """The distillation teacher (train.distill_cfg / distill_ckpt):
        its model from its own config, its weights restored (the raw
        parameters, as JAX's teacher state tracks no EMA; a random
        teacher with a warning without distill_ckpt), frozen in eval
        mode on the trainer's device. It must be a heatmap-family model
        on the student's heatmap grid, keypoints and input size."""
        from tpupose_torch.cli.serve import HEATMAP_FAMILIES
        from tpupose_torch.configs import load_config

        cfg = self.cfg
        tcfg = load_config(cfg.train.distill_cfg)
        if tcfg.model.name not in HEATMAP_FAMILIES:
            raise ValueError(
                "distill teacher must be a heatmap-family model "
                f"{HEATMAP_FAMILIES}; got model.name={tcfg.model.name!r} "
                f"from {cfg.train.distill_cfg}")
        if (tuple(tcfg.model.heatmap_size) != tuple(cfg.model.heatmap_size)
                or tcfg.model.num_keypoints != cfg.model.num_keypoints):
            raise ValueError(
                "distill teacher must emit the student's heatmap grid: "
                f"teacher {tcfg.model.heatmap_size}/"
                f"{tcfg.model.num_keypoints}kp vs student "
                f"{cfg.model.heatmap_size}/{cfg.model.num_keypoints}kp")
        if tuple(tcfg.data.image_size) != tuple(cfg.data.image_size):
            raise ValueError(
                "distill teacher must consume the student's input size "
                f"(teacher {tcfg.data.image_size} vs student "
                f"{cfg.data.image_size}): both run on the same batch")
        tbuilder = Builder(tcfg, self.device)
        teacher = tbuilder.model()
        if cfg.train.distill_ckpt:
            restore_path(TrainState(teacher, tbuilder.optimizer(teacher, 1)),
                         cfg.train.distill_ckpt)
        else:
            printW("distill: no distill_ckpt given, random teacher")
        printT(f"distill: teacher {tcfg.model.name}/{tcfg.model.backbone} "
               f"(w={cfg.train.distill_weight})")
        return teacher.eval().requires_grad_(False)

    # ------------------------------------------------------------------
    @property
    def _batch_keys(self):
        if self.family == "yolo":
            return ("images",) + YOLO_TARGETS
        if self.family == "bottom_up":
            return ("images", "keypoints", "instance_mask")
        return ("images", "joints", "visibility")

    def _step_batch(self, dev: dict) -> dict:
        """A device batch of `_batch_keys` -> what the family's step takes:
        the regression families' targets are the joints normalized by the
        heatmap grid (B, K, 2) in [0, 1]; the others take it as it is."""
        if self.family not in ("regression", "rle"):
            return dev
        Hh, Wh = self.cfg.model.heatmap_size
        wh = torch.tensor([Wh, Hh], dtype=torch.float32, device=self.device)
        return {"images": dev["images"], "target_coords": dev["joints"] / wh,
                "visibility": dev["visibility"]}

    def _prefetched(self, loader, depth: int = 2):
        """Prepared batches on the device, `depth` ahead of the step
        (pinned host memory, non_blocking copies)."""
        for dev in prefetch_to_device(
                ({k: b[k] for k in self._batch_keys} for b in loader),
                self.device, depth):
            yield self._step_batch(dev)

    def _prepare_batch(self, batch, for_eval: bool = False):
        """Host batch -> device batch. The heatmap and SimCC families ship
        images + joints (the targets are rendered in the step), and eval
        renders the targets here (2D Gaussians, or the 1D bin
        distributions); the yolo and bottom-up families ship images and
        their padded instances; the regression families the normalized
        joints."""
        dev = self._step_batch(to_device(
            {k: batch[k] for k in self._batch_keys}, self.device))
        if not for_eval or self.family not in ("heatmap", "simcc"):
            return dev
        if self.family == "simcc":
            from tpupose_torch.losses.simcc import gaussian_1d_targets

            tx, ty, tw = gaussian_1d_targets(
                dev["joints"], dev["visibility"],
                tuple(self.cfg.model.heatmap_size), self.cfg.data.simcc_sigma)
            return {"images": dev["images"], "target": (tx, ty),
                    "target_weight": tw}
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
        profile_dir = self.cfg.train.profile_dir
        for step, db in enumerate(self._prefetched(self.train_loader)):
            if profile_dir and epoch == 0 and step == 10:
                metrics = self._profiled_step(db, profile_dir)
            else:
                metrics = self.train_step(self.state, db)
            self._check_exit_signal()
            n_img += db["images"].shape[0] * self.state.dp_world
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

    def _profiled_step(self, db, profile_dir: str) -> dict:
        """One train step under torch.profiler (CPU, and CUDA on the
        card), its chrome trace written to `profile_dir` (the program's
        `tpupose.train.*` spans among its ranges)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            metrics = self.train_step(self.state, db)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"train_step_rank{self.mesh_mgr.rank}.json"))
        return metrics

    @torch.no_grad()
    def _yolo_val_loss(self, model, db):
        """The yolo family's val loss: a train-mode forward (BatchNorm on
        the batch's statistics, the head's raw per-scale maps), as JAX's
        val step runs it, with the running statistics left as they are."""
        was_training = model.training
        model.train()
        try:
            with frozen_batch_stats():
                preds = model(normalize_images(db["images"], scale_only=True))
        finally:
            model.train(was_training)
        total, _ = self.loss_fn(preds, {k: db[k] for k in
                                        YOLO_TARGETS + ("sample_mask",)})
        return total

    @torch.no_grad()
    def _regression_val_loss(self, model, db):
        """The regression families' val loss on an eval-mode forward; RLE
        gives the forward the target, for the flow's log-density."""
        target, vis = db["target_coords"], db["visibility"]
        if self.family == "rle":
            mu, sigma, log_phi = model.eval()(
                normalize_images(db["images"]), target=target)
            return self.loss_fn(mu, sigma, log_phi, target, vis)
        return self.loss_fn(self.eval_step(model, db["images"]), target, vis)

    def validate(self) -> float:
        """Loss-only validation on the eval weights (the EMA when
        tracked). The padded tail batch's duplicate rows get zero target
        weight (the yolo family: zero instance mask, and zero sample mask
        for the class term, which scores every cell), and batches are
        combined weighted by their real rows."""
        total, n = 0.0, 0
        model = self.state.for_eval()
        for batch in self.valid_loader:
            pm = batch.get("pad_mask")
            db = self._prepare_batch(batch, for_eval=True)
            n_real = int(pm.sum()) if pm is not None else len(batch["images"])
            m = torch.from_numpy(
                pm.astype(np.float32) if pm is not None
                else np.ones(len(batch["images"]), np.float32)).to(self.device)
            padded = pm is not None and not bool(pm.all())
            if self.family == "yolo":
                db["sample_mask"] = m
                if padded:
                    db["instance_mask"] = db["instance_mask"] * m[:, None]
                loss = self._yolo_val_loss(model, db)
            elif self.family == "bottom_up":
                if padded:
                    db["instance_mask"] = db["instance_mask"] * m[:, None]
                loss, _ = self.loss_fn(self.eval_step(model, db["images"]),
                                       db["keypoints"], db["instance_mask"])
            elif self.family in ("regression", "rle"):
                if padded:
                    db["visibility"] = db["visibility"] * m[:, None]
                loss = self._regression_val_loss(model, db)
            else:
                if padded:
                    db["target_weight"] = db["target_weight"] * m[:, None]
                preds = self.eval_step(model, db["images"])
                loss = self.loss_fn(preds, db["target"], db["target_weight"])
            total += float(loss) * n_real
            n += n_real
        if n == 0:
            printW("validation loader produced no batches")
            return float("nan")
        return total / n

    # the names eval.metrics may hold, as in JAX's Trainer; the rest of the
    # metric library reaches evaluation as objects handed to
    # TopDownEvaluator.run
    EVAL_METRICS = ("pck", "pckh", "mpjpe", "oks_ap", "auc", "epe")

    def _build_eval_metrics(self, names=None):
        """Metric objects from `names` (default cfg.eval.metrics)."""
        from tpupose_torch.metrics import METRICS

        out = []
        for name in (self.cfg.eval.metrics if names is None else names):
            if name not in self.EVAL_METRICS:
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
                quant_scales=quant_scales, family=self.family)
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
        if e.int8_engine and self.family != "heatmap":
            raise ValueError("eval.int8_engine serves the heatmap family "
                             f"only (got family={self.family!r})")
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
        """Metric evaluation on the eval weights. Heatmap and SimCC
        families: flip test + decode + back-projection + the metrics of
        eval.metrics (PCK, MPJPE, COCO OKS-AP, ...) over the valid set;
        with eval.dump_results also the COCO keypoint-results JSON. Yolo
        family: `val_loss` and `evaluate_yolo`'s metrics; regression and
        RLE: `val_loss` and `evaluate_regression`'s; bottom-up:
        `evaluate_bottom_up`'s. With eval.det_boxes the heatmap and SimCC
        families add `evaluate_detections`' det_* metrics, on the same
        evaluator (int8 is not calibrated twice)."""
        if self.family == "bottom_up":
            out = self.evaluate_bottom_up()
        elif self.family in ("yolo", "regression", "rle"):
            out = {"val_loss": self.validate()}
            out.update(self.evaluate_yolo() if self.family == "yolo"
                       else self.evaluate_regression())
        else:
            ev = self._get_evaluator()
            out = ev.run(self._eval_batches(), self._build_eval_metrics(),
                         results_path=self.cfg.eval.dump_results or None)
            if self.cfg.eval.det_boxes:
                out.update(self.evaluate_detections(self.cfg.eval.det_boxes,
                                                    evaluator=ev))
        printM("eval: " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
        return out

    def evaluate_detections(self, det_file: str, evaluator=None) -> dict:
        """The official COCO top-down protocol: crops from a detector's
        boxes (a COCO detection-results JSON) instead of the GT boxes,
        scored by OKS-AP against the val annotations (engine/det_eval.py).
        Results carry a det_ prefix, so both protocols report side by
        side. COCO data only (else a warning and no metrics)."""
        from tpupose_torch.engine.det_eval import (DetectionCropDataset,
                                                   evaluate_detections)

        d, e = self.cfg.data, self.cfg.eval
        if d.name != "coco":
            printW("eval.det_boxes requires data.name=coco; skipping")
            return {}
        ds = DetectionCropDataset(
            image_dir=os.path.join(d.root, "val2017"),
            ann_file=os.path.join(d.root, "annotations",
                                  "person_keypoints_val2017.json"),
            det_file=det_file, image_size=tuple(d.image_size),
            heatmap_size=tuple(self.cfg.model.heatmap_size),
            num_keypoints=self.cfg.model.num_keypoints,
            score_threshold=e.det_score_threshold,
            max_per_image=e.det_max_per_image, udp=d.udp)
        out = evaluate_detections(
            evaluator if evaluator is not None else self._get_evaluator(),
            ds, batch_size=e.batch_size, num_workers=d.num_workers,
            nms=e.det_nms, nms_threshold=e.det_nms_threshold,
            vis_threshold=e.det_vis_threshold)
        return {f"det_{k}": v for k, v in out.items()}

    def evaluate_yolo(self) -> dict:
        """COCO keypoint mAP for the single-stage family: YoloPosePredictor
        (forward + decode + NMS on the device) on the eval weights over the
        valid set, OKS-NMS per image (eval.det_nms "oks"), OKS-AP over the
        model's classes."""
        from tpupose_torch.engine.predictor import YoloPosePredictor
        from tpupose_torch.metrics.oks_ap import OKSAP
        from tpupose_torch.ops.oks_nms import oks_nms

        cfg, ecfg = self.cfg, self.cfg.eval
        H, W = cfg.data.image_size
        nc = cfg.model.num_classes
        pred = YoloPosePredictor(
            self.state.for_eval(), num_classes=nc,
            num_keypoints=cfg.model.num_keypoints,
            conf_threshold=ecfg.conf_threshold,
            iou_threshold=ecfg.iou_threshold,
            max_detections=ecfg.max_detections,
            has_box_branch=(cfg.model.reg_max > 0
                            or cfg.loss.name == "v8_pose"),
            device=self.device)
        ap = OKSAP(num_classes=nc)
        wh = np.array([W, H], np.float32)
        for batch in self.valid_loader:
            pm = batch.get("pad_mask")
            if pm is None:
                pm = np.ones(len(batch["images"]), bool)
            det = pred(batch["images"])
            gt_kpts = np.asarray(batch["keypoints"])     # normalized
            gt_boxes = np.asarray(batch["boxes"])        # normalized cxcywh
            gt_cls = np.asarray(batch["classes"])
            imask = np.asarray(batch["instance_mask"]) > 0
            for i in np.flatnonzero(pm):
                keep = np.where(det["valid"][i] > 0)[0]
                pk = det["keypoints"][i][..., :2]
                kv = det["keypoints"][i][..., 2]
                ps = det["scores"][i]
                pb = det["boxes"][i]
                pa = (np.maximum(pb[:, 2] - pb[:, 0], 0.0)
                      * np.maximum(pb[:, 3] - pb[:, 1], 0.0))
                if keep.size and ecfg.det_nms == "oks":
                    # box NMS ran on the device; OKS-NMS removes same-pose
                    # duplicates that survive box IoU
                    keep = keep[oks_nms(pk[keep], ps[keep], pa[keep],
                                        threshold=ecfg.det_nms_threshold,
                                        kscores=kv[keep],
                                        vis_threshold=ecfg.det_vis_threshold)]
                gt_area = (gt_boxes[i, :, 2] * W) * (gt_boxes[i, :, 3] * H)
                ap.update(pk[keep], ps[keep], gt_kpts[i, :, :, :2] * wh,
                          gt_kpts[i, :, :, 2], gt_area,
                          pred_cls=det["classes"][i][keep],
                          gt_cls=gt_cls[i], gt_valid=imask[i],
                          pred_area=pa[keep])
        res = ap.compute()
        return {k: float(v) for k, v in res.items()
                if isinstance(v, (int, float, np.floating))}

    def evaluate_bottom_up(self) -> dict:
        """Detector-free multi-person evaluation: BottomUpPredictor
        (forward, flip-averaged heatmaps where the dataset has flip pairs
        and eval.flip_test is on, AE grouping, all on the device) on the
        eval weights over the valid set, scored by COCO OKS-AP against the
        padded GT instances (the OKS area is the span of each instance's
        labelled joints). With eval.int8 the PTQ scales are calibrated on
        the first validation batch against the current weights."""
        import itertools

        from tpupose_torch.engine.predictor import BottomUpPredictor
        from tpupose_torch.metrics.oks_ap import OKSAP

        cfg, ecfg = self.cfg, self.cfg.eval
        pairs = np.asarray(getattr(self.valid_loader.dataset, "flip_pairs",
                                   np.zeros((0, 2), np.int64)))
        model = self.state.for_eval()
        batches = iter(self.valid_loader)
        quant_scales = None
        if ecfg.int8:
            first = next(batches, None)
            if first is not None:
                batches = itertools.chain([first], batches)
                quant_scales = BottomUpPredictor.calibrate_int8(
                    model, np.asarray(first["images"]))
        pred = BottomUpPredictor(
            model, max_people=cfg.data.max_instances,
            score_threshold=ecfg.ae_score_threshold,
            tag_threshold=ecfg.ae_tag_threshold, quant_scales=quant_scales,
            flip_test=ecfg.flip_test, flip_pairs=pairs, device=self.device)
        H, W = cfg.data.image_size
        wh = np.array([W, H], np.float32)
        ap = OKSAP(num_classes=1)
        for batch in batches:
            pm = batch.get("pad_mask")
            if pm is None:
                pm = np.ones(len(batch["images"]), bool)
            out = pred(batch["images"])
            kpts = np.asarray(batch["keypoints"])        # normalized
            imask = np.asarray(batch["instance_mask"]) > 0
            for i in np.flatnonzero(pm):
                gt_px = kpts[i, :, :, :2] * wh
                gt_vis = kpts[i, :, :, 2]
                # the span of the LABELLED joints: unlabelled ones sit at
                # (0, 0) in yolo labels and would stretch the box
                v = (gt_vis > 0)[..., None]
                hi = np.where(v, gt_px, -np.inf).max(axis=1)
                lo = np.where(v, gt_px, np.inf).min(axis=1)
                span = np.nan_to_num(hi - lo, posinf=0.0, neginf=0.0)
                ap.update(out["coords"][i], out["person_scores"][i], gt_px,
                          gt_vis, span[:, 0] * span[:, 1],
                          pred_valid=out["person_mask"][i],
                          gt_valid=imask[i])
        res = ap.compute()
        return {k: float(v) for k, v in res.items()
                if isinstance(v, (int, float, np.floating))}

    def evaluate_regression(self) -> dict:
        """PCK@0.2, PCKh@0.5 (MPII's head joints 8/9: only where K > 9),
        MPJPE, AUC and EPE of eval.metrics (PCK alone where none applies;
        oks_ap is instance-level and skipped) for the regression families
        (DeepPose; RLE scores its mu). The normalized predictions and the
        GT are compared in source pixels where the batch has a centre and
        scale (back-projected through the heatmap grid as the heatmap
        family's are), else on the heatmap grid."""
        from tpupose_torch.ops.affine import transform_preds

        cfg = self.cfg
        Hh, Wh = cfg.model.heatmap_size
        K = cfg.model.num_keypoints
        names = [n for n in cfg.eval.metrics
                 if n in ("pck", "pckh", "mpjpe", "auc", "epe")]
        if "pckh" in names and K <= 9:
            printW(f"eval metric 'pckh' requested but the model has only "
                   f"{K} keypoints (PCKh needs the MPII head joints 8/9): "
                   f"skipping it")
            names.remove("pckh")
        metrics = self._build_eval_metrics(names or ["pck"])
        model = self.state.for_eval()
        for batch in self._eval_batches():
            preds = self.eval_step(model, torch.as_tensor(
                batch["images"], device=self.device))
            if isinstance(preds, tuple):                 # RLE: (mu, sigma)
                preds = preds[0]
            pred_hm = preds.float().cpu() * torch.tensor([Wh, Hh],
                                                          dtype=torch.float32)
            vis = np.asarray(batch["visibility"], np.float32)
            pm = batch.get("pad_mask")
            if pm is not None:
                vis = vis * pm[:, None]
            if "center" in batch:
                pred_src = transform_preds(
                    pred_hm,
                    torch.from_numpy(np.asarray(batch["center"], np.float32)),
                    torch.from_numpy(np.asarray(batch["scale"], np.float32)),
                    (Hh, Wh), udp=cfg.data.udp).numpy()
                gt_src = np.asarray(batch["joints_src"])
            else:
                pred_src = pred_hm.numpy()
                gt_src = np.asarray(batch["joints"], np.float32)
            for m in metrics:
                m.update(pred_src, gt_src, vis)
        out = {}
        for m in metrics:
            out.update({k: float(v) for k, v in m.compute().items()
                        if isinstance(v, (int, float, np.floating))})
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
                if (self.family in ("heatmap", "simcc", "bottom_up")
                        and self.cfg.eval.run_metrics):
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
