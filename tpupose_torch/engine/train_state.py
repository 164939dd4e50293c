"""Train state and the train/eval steps (counterpart of
tpupose/engine/train_state.py: TrainState, make_heatmap_train_step,
make_simcc_train_step, make_regression_train_step, make_rle_train_step,
make_bottom_up_train_step, make_yolo_train_step, make_heatmap_eval_step).

The JAX step is one compiled program; here it is eager PyTorch on the
model's device. One step: random draws -> affine augmentation (the warp
kernel, csrc/warp.cu, on the card) -> color jitter or normalize, cast to
bf16 as the JAX step does -> Gaussian targets rendered in the step ->
train-mode forward (BatchNorm statistics update, see
models/backbones/resnet.BatchNorm2d) -> loss -> backward -> clip +
update (engine/optimizers.GroupedOptimizer) -> EMA. Nothing in the step
waits for the device: it returns {"loss", "grad_norm"} as tensors.

Random draws: the JAX step folds the step counter into a PRNGKey; the
port draws from a torch.Generator on the batch's device seeded from
(seed, step), so a resumed run draws the same values. Threefry bits
cannot be reproduced by a torch.Generator, so the step also takes the
draws as an argument (the parity tests hand it the JAX package's).

The yolo step (DINOv3Pose): optional mosaic (ops/mosaic.py) -> /255 ->
train-mode forward (the neck's BatchNorm statistics update) -> loss
(ComputeLoss or v8PoseLoss) -> backward -> clip + the grouped update ->
EMA; it returns the loss, grad_norm, each loss part as loss_<part> and,
with mosaic, the mosaic's dropped instances, all device tensors.

The SimCC step is the heatmap step with 1D bin targets (the device
affine and jitter shared); the regression, RLE and bottom-up steps
normalize, forward, take their loss and update, without augmentation,
as in JAX.
"""

from __future__ import annotations

import copy

import torch

from tpupose_torch.ops.affine import draw_affine_augment, random_affine_augment
from tpupose_torch.ops.heatmap import gaussian_heatmaps
from tpupose_torch.ops.mosaic import draw_mosaic, mosaic_augment_normalized
from tpupose_torch.ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                          color_jitter, draw_color_jitter,
                                          normalize_images)


class TrainState:
    """Model, optimizer, update count and an optional EMA of the
    parameters (decay min(d, (1 + t) / (10 + t)) at update t, so early
    EMA tracks the fast-moving init). BatchNorm statistics live in the
    model's buffers; the EMA covers parameters only, as in JAX."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 ema_decay: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.ema_decay = float(ema_decay)
        self.ema = ([p.detach().clone() for p in model.parameters()]
                    if self.ema_decay > 0 else None)
        self._eval_model = None

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """Clip + update from the parameters' .grad (under gradient
        accumulation: add them to the window's mean, and update at its
        end), then the EMA, whose step counts every call; returns the
        global norm of these gradients, the mini-batch's own (device
        tensor)."""
        grad_norm = self.optimizer.step()
        if self.ema is not None:
            t = float(self.step)
            d = min(self.ema_decay, (1.0 + t) / (10.0 + t))
            params = [p.detach() for p in self.model.parameters()]
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, params, alpha=1.0 - d)
        self.step += 1
        return grad_norm

    def for_eval(self) -> torch.nn.Module:
        """The module evaluation should use: the model itself, or (with an
        EMA) a copy carrying the EMA parameters and the live BatchNorm
        statistics."""
        if self.ema is None:
            return self.model
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model)
        with torch.no_grad():
            for e, p in zip(self._eval_model.parameters(), self.ema):
                e.copy_(p)
            for e, b in zip(self._eval_model.buffers(), self.model.buffers()):
                e.copy_(b)
        return self._eval_model.eval()

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema}

    def load_state_dict(self, sd: dict):
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            src = sd.get("ema") or [p.detach() for p in
                                    self.model.parameters()]
            with torch.no_grad():
                for e, s in zip(self.ema, src):
                    e.copy_(s)


def step_seed(seed: int, step: int) -> int:
    """The draw generator's seed for update `step` of a run seeded
    `seed` (both as 32-bit fields of one 64-bit seed)."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def _make_draws_for(seed: int, use_affine: bool, rotation: float,
                    scale: float, jitter: float):
    """`draws_for(step, batch, device)`: the affine and color-jitter draws
    of update `step`, from a generator seeded from (seed, step) alone."""

    def draws_for(step: int, batch: int, device) -> dict:
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(seed, step))
        out = {}
        if use_affine:
            out["affine"] = draw_affine_augment(g, batch, rotation, scale)
        if jitter > 0:
            out["jitter"] = draw_color_jitter(g, batch, jitter)
        return out

    return draws_for


def _augment(images, joints, vis, draws, use_affine: bool, grid_hw,
             udp: bool, jitter: float):
    """The top-down steps' device augmentation: the affine warp (K7 on the
    card; joints move on the target grid `grid_hw`, heatmap or bin), then
    color jitter + normalize (or the plain normalize), cast to bf16 as
    the JAX step casts. Returns (images, joints, visibility)."""
    if use_affine:
        mult, rot = draws["affine"]
        images, joints, vis = random_affine_augment(
            images, joints, vis, mult, rot, tuple(grid_hw), udp=udp)
    if jitter > 0:
        x = color_jitter(images.to(torch.float32) * (1.0 / 255.0),
                         draws["jitter"])
        m = torch.tensor(IMAGENET_MEAN, device=x.device)
        s = torch.tensor(IMAGENET_STD, device=x.device)
        return ((x - m) / s).to(torch.bfloat16), joints, vis
    return normalize_images(images), joints, vis


def _backward_update(state: TrainState, loss) -> dict:
    state.optimizer.zero_grad()
    loss.backward()
    grad_norm = state.apply_gradients()
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def make_heatmap_train_step(loss_fn, color_jitter_strength: float = 0.0,
                            jitter_seed: int = 0, heatmap_size=None,
                            sigma: float = 2.0, affine_rotation: float = 0.0,
                            affine_scale: float = 0.0, udp: bool = False,
                            teacher: torch.nn.Module | None = None,
                            distill_weight: float = 0.5):
    """The heatmap-family train step, `step(state, batch, draws=None)`.

    batch: {"images": uint8/float NHWC} plus EITHER {"target" (B, Hh, Wh,
    K), "target_weight" (B, K)} OR {"joints" (B, K, 2) heatmap px,
    "visibility" (B, K)}, whose Gaussian targets are rendered in the step.
    affine_rotation / affine_scale > 0 run the rotation/scale warp on the
    images and move the joints with them; color_jitter_strength > 0
    jitters brightness, contrast and saturation. draws: {"affine": (mult,
    rot), "jitter": (brightness, contrast, saturation)}; by default
    `step.draws_for(state.step, B, device)`. Updates `state` in place and
    returns {"loss", "grad_norm"} as device tensors.

    teacher: heatmap knowledge distillation (FPD, Zhang et al., CVPR
    2019). The frozen teacher's eval-mode forward runs without a graph on
    the same augmented, jittered and normalised pixels, and the loss is
    (1 - w) task + w joints_mse(student, teacher, target_weight) with w =
    distill_weight; the metrics gain "task_loss" and "kd_loss"."""
    from tpupose_torch.losses.heatmap import joints_mse_loss
    use_affine = affine_rotation > 0 or affine_scale > 0
    if use_affine and heatmap_size is None:
        raise ValueError("device affine augmentation needs heatmap_size")
    draws_for = _make_draws_for(jitter_seed, use_affine, affine_rotation,
                                affine_scale, color_jitter_strength)

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        if use_affine and "target" in batch:
            raise ValueError("device affine augmentation needs raw joints, "
                             "not precomputed targets")
        images = batch["images"]
        if draws is None:
            draws = draws_for(state.step, images.shape[0], images.device)
        imgs, joints, vis = _augment(
            images, batch.get("joints"), batch.get("visibility"), draws,
            use_affine, heatmap_size, udp, color_jitter_strength)
        if "target" in batch:
            target, tw = batch["target"], batch.get("target_weight")
        else:
            if heatmap_size is None:
                raise ValueError("need heatmap_size to render targets")
            t, tw = gaussian_heatmaps(joints, vis, tuple(heatmap_size), sigma)
            target = t.permute(0, 2, 3, 1)               # NKHW -> NHWK
        model = state.model.train()
        pred = model(imgs)
        task = loss_fn(pred, target, tw)
        if teacher is None:
            return _backward_update(state, task)
        with torch.no_grad():
            t_hm = teacher.eval()(imgs)
        kd = joints_mse_loss(pred, t_hm, tw)
        metrics = _backward_update(
            state, (1.0 - distill_weight) * task + distill_weight * kd)
        metrics.update(task_loss=task.detach(), kd_loss=kd.detach())
        return metrics

    train_step.draws_for = draws_for
    return train_step


def make_simcc_train_step(loss_fn, bins_hw, sigma: float = 6.0,
                          color_jitter_strength: float = 0.0,
                          jitter_seed: int = 0,
                          affine_rotation: float = 0.0,
                          affine_scale: float = 0.0, udp: bool = False):
    """The SimCC train step (models/simcc.py), `step(state, batch,
    draws=None)`. batch: {"images" uint8 NHWC, "joints" (B, K, 2) in BIN
    coordinates, "visibility" (B, K)}. The 1D Gaussian bin targets are
    rendered in the step; the device affine (K7 on the card) and the
    color jitter run as in the heatmap step, the joints moving on the bin
    grid. Returns {"loss", "grad_norm"} as device tensors."""
    from tpupose_torch.losses.simcc import gaussian_1d_targets

    bins_hw = tuple(bins_hw)
    use_affine = affine_rotation > 0 or affine_scale > 0
    draws_for = _make_draws_for(jitter_seed, use_affine, affine_rotation,
                                affine_scale, color_jitter_strength)

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        images = batch["images"]
        if draws is None:
            draws = draws_for(state.step, images.shape[0], images.device)
        imgs, joints, vis = _augment(
            images, batch["joints"], batch["visibility"], draws, use_affine,
            bins_hw, udp, color_jitter_strength)
        tx, ty, tw = gaussian_1d_targets(joints, vis, bins_hw, sigma)
        model = state.model.train()
        return _backward_update(state, loss_fn(model(imgs), (tx, ty), tw))

    train_step.draws_for = draws_for
    return train_step


def _no_draws(step: int, batch: int, device) -> dict:
    return {}


def make_regression_train_step(loss_fn):
    """The coordinate-regression (DeepPose) train step, `step(state,
    batch, draws=None)`. batch: {"images" uint8 NHWC, "target_coords"
    (B, K, 2) normalized, "visibility" (B, K)}."""

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        model = state.model.train()
        preds = model(normalize_images(batch["images"]))
        return _backward_update(state, loss_fn(preds, batch["target_coords"],
                                               batch.get("visibility")))

    train_step.draws_for = _no_draws
    return train_step


def make_rle_train_step(loss_fn):
    """The RLE train step (DeepPose(rle=True)), `step(state, batch,
    draws=None)`; batch as make_regression_train_step's. The forward
    takes the target and returns (mu, sigma, log_phi); loss_fn is
    losses/rle.rle_loss bound to residual / q, whose NLL reaches the
    flow, the head and the backbone in one backward."""

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        model = state.model.train()
        target = batch["target_coords"]
        mu, sigma, log_phi = model(normalize_images(batch["images"]),
                                   target=target)
        return _backward_update(state, loss_fn(mu, sigma, log_phi, target,
                                               batch.get("visibility")))

    train_step.draws_for = _no_draws
    return train_step


def make_bottom_up_train_step(loss_fn):
    """The bottom-up AE train step (models/bottom_up.py), `step(state,
    batch, draws=None)`. batch: {"images" uint8 NHWC, "keypoints" (B, M,
    K, 3) normalized, "instance_mask" (B, M)}, the yolo family's padded
    contract. The multi-person targets and the tag push/pull terms render
    in the step (losses/ae.ae_loss). Returns {"loss", "grad_norm",
    "hm_loss", "pull", "push"} as device tensors."""

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        model = state.model.train()
        pred = model(normalize_images(batch["images"]))
        loss, parts = loss_fn(pred, batch["keypoints"],
                              batch["instance_mask"])
        metrics = _backward_update(state, loss)
        metrics.update({k: v.detach() for k, v in parts.items()})
        return metrics

    train_step.draws_for = _no_draws
    return train_step


YOLO_TARGETS = ("boxes", "classes", "keypoints", "instance_mask")


def make_yolo_train_step(loss_fn, mosaic_prob: float = 0.0,
                         mosaic_seed: int = 0):
    """The single-stage (YOLO-pose) train step, `step(state, batch,
    draws=None)`.

    batch: {"images" uint8 NHWC, "boxes" (B, M, 4) normalized cxcywh,
    "classes" (B, M), "keypoints" (B, M, K, 3) normalized, "instance_mask"
    (B, M)}. loss_fn: (per-scale raw maps, targets) -> (total, parts).
    mosaic_prob > 0 runs the 4-image mosaic per image with that
    probability, labels moved with it; draws: {"mosaic": draw_mosaic's},
    by default `step.draws_for(state.step, B, device)`. Updates `state` in
    place and returns {"loss", "grad_norm", "loss_<part>"...[,
    "mosaic_dropped"]} as device tensors."""

    def draws_for(step: int, batch: int, device) -> dict:
        if mosaic_prob <= 0:
            return {}
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(mosaic_seed, step))
        return {"mosaic": draw_mosaic(g, batch)}

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        images = batch["images"]
        targets = {k: batch[k] for k in YOLO_TARGETS}
        extra = {}
        if mosaic_prob > 0:
            if draws is None:
                draws = draws_for(state.step, images.shape[0], images.device)
            (images, targets["boxes"], targets["classes"],
             targets["keypoints"], targets["instance_mask"],
             extra["mosaic_dropped"]) = mosaic_augment_normalized(
                images, targets["boxes"], targets["classes"],
                targets["keypoints"], targets["instance_mask"],
                draws["mosaic"], prob=mosaic_prob)
        imgs = normalize_images(images, scale_only=True)
        model = state.model.train()
        loss, parts = loss_fn(model(imgs), targets)
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        metrics.update({f"loss_{k}": v.detach() for k, v in parts.items()})
        metrics.update(extra)
        return metrics

    train_step.draws_for = draws_for
    return train_step


def make_heatmap_eval_step():
    """`eval_step(model, images)`: normalize -> eval-mode forward ->
    heatmaps (B, Hh, Wh, K), no gradients."""

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, images: torch.Tensor):
        return model.eval()(normalize_images(images))

    return eval_step
