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

from tpupose_torch._device import constant
from tpupose_torch.engine.step_graphs import StepGraphs, graph_blocker
from tpupose_torch.ops.affine import draw_affine_augment, random_affine_augment
from tpupose_torch.ops.heatmap import gaussian_heatmaps
from tpupose_torch.ops.mosaic import draw_mosaic, mosaic_augment_normalized
from tpupose_torch.ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                          color_jitter, draw_color_jitter,
                                          normalize_images)
from tpupose_torch.parallel.tensor_parallel import (full_state_dict,
                                                    full_tensor, gather_full,
                                                    load_full_state_dict,
                                                    local_part, shard_of)
from tpupose_torch.utils import trace


class TrainState:
    """Model, optimizer, update count and an optional EMA of the
    parameters (decay min(d, (1 + t) / (10 + t)) at update t, so early
    EMA tracks the fast-moving init). BatchNorm statistics live in the
    model's buffers; the EMA covers parameters only, as in JAX.

    Under tensor parallelism (parallel/tensor_parallel.py) the model's
    wide layers, their EMA and their optimizer state hold this model
    rank's output channels; `for_eval` and `state_dict` gather them
    (every model rank must call them) and `load_state_dict` takes this
    rank's block of a full state, so a checkpoint is the one-process
    format whatever the model axis."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 ema_decay: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.ema_decay = float(ema_decay)
        self.ema = ([p.detach().clone() for p in model.parameters()]
                    if self.ema_decay > 0 else None)
        # the EMA's decay as a 0-dim device tensor that `load_schedules`
        # fills, once `make_capturable` has run (else a float from the
        # host's step count)
        self._ema_d = None
        # loads of a state (`load_state_dict`): graphs captured before one
        # are dropped (engine/step_graphs.py)
        self.reloads = 0
        self._eval_model = None
        # data parallelism (Trainer under torchrun): this process's data
        # rank of `dp_world` in the data group `dp_group` (None: the
        # default group), and the DistributedDataParallel wrapper the
        # steps run the model through
        self.dp_rank, self.dp_world, self.dp_group = 0, 1, None
        self.ddp = None

    def train_module(self) -> torch.nn.Module:
        """The module a train step calls, in train mode: the model, or its
        DistributedDataParallel wrapper."""
        self.model.train()
        return self.ddp if self.ddp is not None else self.model

    def local_draws(self, draws_for, batch: int, device) -> dict:
        """The step's random draws for this rank's `batch` rows: drawn for
        the global batch (batch x dp_world rows, the same on every rank)
        and cut to this rank's slice, so the ranks together draw what one
        process draws at the global batch."""
        draws = draws_for(self.step, batch * self.dp_world, device)
        if self.dp_world == 1:
            return draws
        rows = slice(self.dp_rank * batch, (self.dp_rank + 1) * batch)
        return {k: tuple(t[rows] for t in v) for k, v in draws.items()}

    def global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """A per-rank scalar averaged over the data group (t itself on
        one rank; the model ranks of one data index hold the same t)."""
        if self.dp_world == 1:
            return t
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=self.dp_group)
        return t / self.dp_world

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """Clip + update from the parameters' .grad (under gradient
        accumulation: add them to the window's mean, and update at its
        end), then the EMA, whose step counts every call; returns the
        global norm of these gradients, the mini-batch's own (device
        tensor)."""
        grad_norm = self.optimizer.step()
        if self.ema is not None:
            params = [p.detach() for p in self.model.parameters()]
            d = self._ema_d
            if d is None:
                d = self._decay()
                torch._foreach_mul_(self.ema, d)
                torch._foreach_add_(self.ema, params, alpha=1.0 - d)
            else:
                torch._foreach_mul_(self.ema, d)
                torch._foreach_add_(self.ema,
                                    torch._foreach_mul(params, 1.0 - d))
        self.step += 1
        return grad_norm

    def _decay(self) -> float:
        t = float(self.step)
        return min(self.ema_decay, (1.0 + t) / (10.0 + t))

    def make_capturable(self):
        """Make the update one that a CUDA graph can capture and replay
        (engine/step_graphs.py): the optimizer's (GroupedOptimizer.
        make_capturable) and the EMA's decay as a device tensor. From then
        on the caller fills them before each update (`load_schedules`), as
        StepGraphs does. Idempotent."""
        self.optimizer.make_capturable()
        if self.ema is not None and self._ema_d is None:
            self._ema_d = torch.zeros((), dtype=torch.float32,
                                      device=self.ema[0].device)

    def load_schedules(self):
        """Fill the device scalars of a capturable state (each group's lr,
        the EMA's decay) for the update the host's counters stand at: the
        values that the next update reads, eager, captured or replayed.
        Nothing on a state that is not capturable."""
        self.optimizer.load_lrs()
        if self._ema_d is not None:
            self._ema_d.fill_(self._decay())

    def count_replayed_update(self):
        """Advance the host's counters past an update that a graph's
        replay made (GroupedOptimizer.step's count, apply_gradients'
        step)."""
        self.optimizer.count += 1
        self.step += 1

    def _sharded(self) -> bool:
        return any(shard_of(p) is not None for p in self.model.parameters())

    def for_eval(self) -> torch.nn.Module:
        """The module evaluation should use: the model itself, or (with an
        EMA) a copy carrying the EMA parameters and the live BatchNorm
        statistics; under tensor parallelism a full, unsharded copy of
        either (gathered at every call)."""
        if self._sharded():
            self._eval_model = gather_full(self.model, self._eval_model,
                                           params=self.ema)
            return self._eval_model.eval()
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
        """The one-process format: sharded weights, their EMA and their
        optimizer state gathered."""
        ema = self.ema
        if ema is not None:
            ema = [full_tensor(e, shard_of(p))
                   for e, p in zip(ema, self.model.parameters())]
        return {"step": self.step, "model": full_state_dict(self.model),
                "optimizer": self.optimizer.state_dict(), "ema": ema}

    def load_state_dict(self, sd: dict):
        """Load a one-process state (each sharded tensor takes this
        rank's block)."""
        self.step = int(sd["step"])
        self.reloads += 1
        load_full_state_dict(self.model, sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            params = list(self.model.parameters())
            src = sd.get("ema")
            src = ([local_part(s, shard_of(p)) for s, p in zip(src, params)]
                   if src else [p.detach() for p in params])
            with torch.no_grad():
                for e, s in zip(self.ema, src):
                    e.copy_(s)


def step_seed(seed: int, step: int) -> int:
    """The draw generator's seed for update `step` of a run seeded
    `seed`: one 64-bit seed, the seed in its high 32 bits, and in its low
    32 bits the step mixed with the seed (a CPU generator keeps only the
    low 32 bits of its seed, so they must depend on both)."""
    low = (step ^ (seed * 0x9E3779B1)) & 0xFFFFFFFF
    return ((seed & 0xFFFFFFFF) << 32) | low


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
    color jitter (where `jitter` > 0) and normalize_images' normalize,
    its statistics kept on the device (a graph capture refuses their
    copy from a list), cast to bf16 as the JAX step casts. Returns
    (images, joints, visibility)."""
    if use_affine:
        mult, rot = draws["affine"]
        images, joints, vis = random_affine_augment(
            images, joints, vis, mult, rot, tuple(grid_hw), udp=udp)
    x = images.to(torch.float32) * (1.0 / 255.0)
    if jitter > 0:
        x = color_jitter(x, draws["jitter"])
    m = constant(IMAGENET_MEAN, x.device)
    s = constant(IMAGENET_STD, x.device)
    return ((x - m) / s).to(torch.bfloat16), joints, vis


def _backward_update(state: TrainState, loss) -> dict:
    """Backward (DDP averages the gradients over the ranks as it goes),
    clip + update; the loss reported is the ranks' mean."""
    with trace.span("train.backward"):
        state.optimizer.zero_grad()
        loss.backward()
    with trace.span("train.update"):
        grad_norm = state.apply_gradients()
        return {"loss": state.global_mean(loss.detach()),
                "grad_norm": grad_norm}


def make_heatmap_train_step(loss_fn, color_jitter_strength: float = 0.0,
                            jitter_seed: int = 0, heatmap_size=None,
                            sigma: float = 2.0, affine_rotation: float = 0.0,
                            affine_scale: float = 0.0, udp: bool = False,
                            teacher: torch.nn.Module | None = None,
                            distill_weight: float = 0.5, count=None):
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
    distill_weight; the metrics gain "task_loss" and "kd_loss". `count`
    normalises the distillation loss as loss_fn's own (losses/
    normalize.py; this process's batch by default).

    On the card, where `graph_blocker(state)` finds nothing in the way
    (one process, the whole model, no accumulation, Adam, AdamW or SGD),
    the step runs from a CUDA graph from the second call of an input
    signature on (engine/step_graphs.py; `step.graphs`): the same body,
    captured."""
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.losses.normalize import local_count

    count = count or local_count
    use_affine = affine_rotation > 0 or affine_scale > 0
    if use_affine and heatmap_size is None:
        raise ValueError("device affine augmentation needs heatmap_size")
    draws_for = _make_draws_for(jitter_seed, use_affine, affine_rotation,
                                affine_scale, color_jitter_strength)
    graphs = StepGraphs()

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        if use_affine and "target" in batch:
            raise ValueError("device affine augmentation needs raw joints, "
                             "not precomputed targets")
        with trace.root("train.step"):
            if graph_blocker(state) is None:
                return graphs(state, batch, draws, draws_for, _heatmap_step)
            return _heatmap_step(state, batch, draws)

    def _heatmap_step(state, batch, draws):
        with trace.span("train.input"):
            images = batch["images"]
            if draws is None:
                draws = state.local_draws(draws_for, images.shape[0],
                                          images.device)
            imgs, joints, vis = _augment(
                images, batch.get("joints"), batch.get("visibility"), draws,
                use_affine, heatmap_size, udp, color_jitter_strength)
            if "target" in batch:
                target, tw = batch["target"], batch.get("target_weight")
            else:
                if heatmap_size is None:
                    raise ValueError("need heatmap_size to render targets")
                t, tw = gaussian_heatmaps(joints, vis, tuple(heatmap_size),
                                          sigma)
                target = t.permute(0, 2, 3, 1)           # NKHW -> NHWK
        with trace.span("train.forward"):
            model = state.train_module()
            pred = model(imgs)
            task = loss_fn(pred, target, tw)
            if teacher is not None:
                with torch.no_grad():
                    t_hm = teacher.eval()(imgs)
                kd = joints_mse_loss(pred, t_hm, tw, count=count)
        if teacher is None:
            return _backward_update(state, task)
        metrics = _backward_update(
            state, (1.0 - distill_weight) * task + distill_weight * kd)
        metrics.update(task_loss=state.global_mean(task.detach()),
                       kd_loss=state.global_mean(kd.detach()))
        return metrics

    train_step.draws_for = draws_for
    train_step.graphs = graphs
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
        with trace.root("train.step"):
            with trace.span("train.input"):
                images = batch["images"]
                if draws is None:
                    draws = state.local_draws(draws_for, images.shape[0],
                                              images.device)
                imgs, joints, vis = _augment(
                    images, batch["joints"], batch["visibility"], draws,
                    use_affine, bins_hw, udp, color_jitter_strength)
                tx, ty, tw = gaussian_1d_targets(joints, vis, bins_hw, sigma)
            with trace.span("train.forward"):
                model = state.train_module()
                loss = loss_fn(model(imgs), (tx, ty), tw)
            return _backward_update(state, loss)

    train_step.draws_for = draws_for
    return train_step


def _no_draws(step: int, batch: int, device) -> dict:
    return {}


def make_regression_train_step(loss_fn):
    """The coordinate-regression (DeepPose) train step, `step(state,
    batch, draws=None)`. batch: {"images" uint8 NHWC, "target_coords"
    (B, K, 2) normalized, "visibility" (B, K)}."""

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        model = state.train_module()
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
        model = state.train_module()
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
        model = state.train_module()
        pred = model(normalize_images(batch["images"]))
        loss, parts = loss_fn(pred, batch["keypoints"],
                              batch["instance_mask"])
        metrics = _backward_update(state, loss)
        metrics.update({k: state.global_mean(v.detach())
                        for k, v in parts.items()})
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

    def draws_for(step: int, batch: int, device, rank: int = 0) -> dict:
        if mosaic_prob <= 0:
            return {}
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(mosaic_seed + (rank << 16), step))
        return {"mosaic": draw_mosaic(g, batch)}

    def train_step(state: TrainState, batch: dict, draws: dict = None):
        images = batch["images"]
        targets = {k: batch[k] for k in YOLO_TARGETS}
        extra = {}
        if mosaic_prob > 0:
            if draws is None:
                # the mosaic mixes the images of one batch: under data
                # parallelism each data rank mixes its own, on its own
                # draws (the model ranks of a data index on the same)
                draws = draws_for(state.step, images.shape[0], images.device,
                                  state.dp_rank)
            (images, targets["boxes"], targets["classes"],
             targets["keypoints"], targets["instance_mask"],
             extra["mosaic_dropped"]) = mosaic_augment_normalized(
                images, targets["boxes"], targets["classes"],
                targets["keypoints"], targets["instance_mask"],
                draws["mosaic"], prob=mosaic_prob)
        imgs = normalize_images(images, scale_only=True)
        model = state.train_module()
        loss, parts = loss_fn(model(imgs), targets)
        metrics = _backward_update(state, loss)
        metrics.update({f"loss_{k}": state.global_mean(v.detach())
                        for k, v in parts.items()})
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
