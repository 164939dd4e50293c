"""Typed default configuration tree (the port's copy of
tpupose/configs/default.py).

The same nested dataclasses, defaults, YAML merge (`merge_dict`), dotted
CLI overrides (`merge_dotted`, `_coerce`) and freeze semantics. The
port's own copies of the method YAMLs are under
tpupose_torch/configs/method/. `mesh` is the (data, model) layout
(tpupose_torch/parallel/mesh.py) of torchrun's processes, each on its
own device: `mesh.model` ranks share one data slice and shard the wide
layers' output channels (the tensor-parallel axis,
parallel/tensor_parallel.py), `mesh.data` of those groups split the
batch.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ModelConfig:
    # registry name: simple_baseline | hrnet | dinov3_pose | deeppose | fskd | fcmae
    name: str = "simple_baseline"
    backbone: str = "resnet50"          # resnet{18,34,50,101,152} | convnext_{...} | vit_{...} | hrnet_w{32,48}
    pretrained: str = ""                # path to converted .npz / orbax weights
    checkpoint: str = ""                # resume/eval checkpoint
    num_keypoints: int = 17             # COCO-17 default; reference yolo config uses 4
    num_classes: int = 1                # reference dinov3_pose.yaml uses ncls 7
    # top-down heatmap options
    heatmap_size: tuple = (64, 48)      # (H, W); for simcc: the BIN grid
    deconv_channels: tuple = (256, 256, 256)
    decoder: str = "classic"            # vitpose head: classic | simple
    # simcc options (models/simcc.py): bins per input pixel; requires
    # heatmap_size == image_size * split_ratio (Builder enforces)
    split_ratio: float = 2.0
    # single-stage (yolo-pose) options
    neck_channels: tuple = (192, 384, 768)
    strides: tuple = (8, 16, 32)
    freeze_backbone: bool = False       # dinov3 configs set true (the
                                        # reference freezes DINOv3,
                                        # HPE/models/pose.py:47-49); a True
                                        # default silently froze every OTHER
                                        # family's backbone at init
    kpt_dim: int = 3                    # (x, y, visibility)
    reg_max: int = 0                    # >0: v8 DFL box branch (required by loss v8_pose)


@dataclass
class DataConfig:
    name: str = "synthetic"             # synthetic | coco | yolo_pose | fewshot
    root: str = ""
    train_dir: str = ""
    valid_dir: str = ""
    image_size: tuple = (256, 192)      # (H, W); yolo-pose uses (640, 640)
    max_instances: int = 32             # static padding of ragged per-image targets
    num_workers: int = 4
    # native host-IO (data/native_io.py): decode threads (0 = one per
    # host core) and the decode-once/warp-per-epoch source cache budget
    # in MB (0 = off; decode dominates the feed on few-core hosts)
    decode_threads: int = 0
    decode_cache_mb: int = 0
    # top-down augmentation (reference scope per BASELINE.json north star)
    scale_factor: float = 0.25
    rotation_factor: float = 30.0
    flip_prob: float = 0.5
    # half-body transform (HRNet crop aug; 0 = off, standard COCO: 0.3):
    # re-center the crop on visible upper- or lower-body joints only
    half_body_prob: float = 0.0
    half_body_min_joints: int = 8
    # single-stage (yolo-pose) family: per-image probability of the
    # on-device 4-image mosaic (ops/mosaic.py), fused into the train step
    mosaic_prob: float = 0.0
    color_jitter: float = 0.2
    # True: rotation/scale augmentation runs INSIDE the train step
    # (ops/affine.random_affine_augment); the host ships the canonical
    # crop and only applies the flip. False: classic host-side aug.
    device_affine: bool = False
    # unbiased (unit-length) data processing, UDP CVPR 2020: all crop/label
    # affines measure the grid in N-1 intervals; flip-test mirror becomes
    # exact (no 1-px shift). One flag drives dataset + train-step aug +
    # evaluator so the convention can never be mixed.
    udp: bool = False
    sigma: float = 2.0                  # Gaussian target sigma
    simcc_sigma: float = 6.0            # 1D bin-target sigma (simcc family)
    # few-shot episodic options (reference: HPE/configs/default.py:21-53)
    n_way: int = 5
    k_shot: int = 1
    n_query: int = 4
    episodes_per_epoch: int = 100


@dataclass
class TrainConfig:
    batch_size: int = 64                # global batch
    epochs: int = 100
    warmup_epochs: int = 3              # reference: HPE/train.py:94-103
    grad_clip_norm: float = 10.0        # reference: HPE/train.py:133, pose trainer :67
    grad_accum_steps: int = 1           # reference mini_batch_count (HPE/engine/trainer.py:96-100)
    mixed_precision: bool = True        # bf16 autocast over float32 weights (no GradScaler needed)
    seed: int = 42
    deterministic: bool = False
    log_interval: int = 50
    ckpt_interval: int = 1              # epochs between periodic checkpoints
    output_dir: str = "output"
    experiment: str = "default"
    profile_dir: str = ""               # non-empty: a torch.profiler chrome trace of epoch 0 step 10 written here
    tensorboard: bool = True            # tfevents scalars under <exp>/tb
    # > 0: track an EMA of the params (fused into the train step) and use
    # it for validation/metric eval/serving. 0 disables. Typical: 0.9998.
    ema_decay: float = 0.0
    # rematerialize backbone blocks in the backward pass (the port: ViTPose
    # only; SimpleBaseline raises):
    # trades ~1 extra forward for an O(1)-block activation stash — unlocks
    # larger per-chip batches on HBM-limited configs (HRNet@384, big ViTs)
    remat: bool = False
    # heatmap knowledge distillation (FPD, Zhang et al. CVPR 2019):
    # distill_cfg = YAML of the TEACHER model (any heatmap family with the
    # same heatmap_size/num_keypoints); distill_ckpt = its trained
    # checkpoint (supports <dir>@best). The teacher's frozen eval forward
    # runs inside the compiled train step; loss becomes
    # (1-w)·task + w·MSE(student_hm, teacher_hm).
    distill_cfg: str = ""
    distill_ckpt: str = ""
    distill_weight: float = 0.5


@dataclass
class EvalConfig:
    batch_size: int = 64
    flip_test: bool = True
    decode: str = "dark"                # dark | quarter_offset | argmax
    blur_kernel: int = 11               # DARK modulation kernel
    oks_thresholds: tuple = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))
    # single-stage postprocess
    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_detections: int = 100
    video_batch: int = 8                # frames per device batch (cli/video)
    interval: int = 1
    run_metrics: bool = False           # metric eval each interval (heatmap)
    # non-empty: Trainer.evaluate/--test also dumps every prediction as a
    # standard COCO keypoint-results JSON (pycocotools-scoreable)
    dump_results: str = ""
    # non-empty: ALSO run the official detection-box protocol (crops from
    # a COCO detection-results JSON instead of GT boxes) and report the AP
    # suite under det_* (engine/det_eval.py). coco data only.
    det_boxes: str = ""
    det_score_threshold: float = 0.0
    det_max_per_image: int = 100
    # instance dedup before AP scoring (ops/oks_nms.py): the official
    # protocol's oks_nms(thr=0.9, in_vis_thre=0.2); soft_oks | none
    det_nms: str = "oks"
    det_nms_threshold: float = 0.9
    det_vis_threshold: float = 0.2
    # bottom-up AE grouping decode (ops/ae_decode.py)
    ae_score_threshold: float = 0.1
    ae_tag_threshold: float = 1.0
    int8: bool = False                  # serve inference/eval with int8 PTQ
                                        # (ops/quant.py; calibrated on the
                                        # first batch seen)
    int8_engine: bool = False           # serve eval with the fused
                                        # int8-activation engine
                                        # (ops/int8_engine.py; SimpleBaseline
                                        # /HRNet heatmap families only)
    # metric set for Trainer.evaluate / --test: names from tpupose.metrics
    metrics: tuple = ("pck", "mpjpe", "oks_ap")


@dataclass
class LossConfig:
    name: str = "joints_mse"            # joints_mse | pose_compute (center-cell) | v8_pose (TAL)
    kpt_loss_type: str = "oks"          # oks | wing | adaptive_wing | multiscale | hybrid
    cls_weight: float = 1.0             # reference weights (HPE/loss.py:437-446)
    kpt_weight: float = 10.0
    vis_weight: float = 5.0
    use_target_weight: bool = True
    # rle (losses/rle.py): residual Q-term on/off and its distribution
    rle_residual: bool = True
    rle_q: str = "laplace"              # laplace | gaussian
    # associative embedding (losses/ae.py, loss.name=ae): tag sigma of the
    # push term and the Newell 1e-3 grouping weights
    ae_tag_sigma: float = 1.0
    ae_pull_weight: float = 1e-3
    ae_push_weight: float = 1e-3


@dataclass
class OptimizerConfig:
    name: str = "adamw"                 # registry covers the reference's 13 torch optimizers
    lr: float = 1e-3
    head_lr: float = 1e-2               # two param groups (reference: HPE/train.py:39-55)
    weight_decay: float = 1e-4
    betas: tuple = (0.9, 0.999)
    momentum: float = 0.9
    eps: float = 1e-8


@dataclass
class SchedulerConfig:
    name: str = "cosine"                # cosine | step | multistep | exponential | plateau-free set
    min_lr: float = 1e-6
    step_size: int = 30
    gamma: float = 0.1
    milestones: tuple = (60, 90)


@dataclass
class ServeConfig:
    """HTTP serving front end (cli/serve.py, engine/server.py)."""
    host: str = "127.0.0.1"
    port: int = 8080                    # 0: pick an ephemeral port
    max_batch: int = 32                 # largest micro-batch (top bucket)
    window_ms: float = 4.0              # coalescing window per batch


@dataclass
class MeshConfig:
    """(data, model) layout (the `--gpus` analog)."""
    data: int = -1                      # -1: every process model leaves
    model: int = 1                      # tensor-parallel axis


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    _frozen: bool = field(default=False, repr=False, compare=False)

    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        return self

    def __setattr__(self, k, v):
        if getattr(self, "_frozen", False) and k != "_frozen":
            raise AttributeError(f"Config is frozen; cannot set {k!r}")
        object.__setattr__(self, k, v)

    def to_dict(self) -> dict:
        def conv(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {
                    f.name: conv(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)
                    if not f.name.startswith("_")
                }
            if isinstance(obj, (list, tuple)):
                return [conv(x) for x in obj]
            return obj

        return conv(self)

    def merge_dict(self, overrides: dict) -> "Config":
        """Recursively merge a (possibly partial) dict of overrides."""
        if getattr(self, "_frozen", False):
            raise AttributeError("Config is frozen")
        _merge_into(self, overrides)
        return self

    def merge_dotted(self, items: dict) -> "Config":
        """Merge flat {'train.batch_size': 32} style CLI overrides."""
        for key, val in items.items():
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            cur = getattr(node, parts[-1])
            setattr(node, parts[-1], _coerce(val, cur))
        return self

    def clone(self) -> "Config":
        c = copy.deepcopy(self)
        object.__setattr__(c, "_frozen", False)
        return c


def _merge_into(node, overrides: dict):
    for k, v in overrides.items():
        if not hasattr(node, k):
            raise KeyError(f"Unknown config key: {k!r}")
        cur = getattr(node, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v)
        else:
            setattr(node, k, _coerce(v, cur))


def _coerce(val: Any, current: Any):
    """Coerce YAML/CLI values toward the default's type (tuples, bools, numbers)."""
    if isinstance(current, bool) and isinstance(val, str):
        return val.lower() in ("1", "true", "yes", "on")
    if isinstance(current, tuple) and isinstance(val, str):
        import ast

        return tuple(ast.literal_eval(val))
    if isinstance(current, tuple) and isinstance(val, (list, tuple)):
        return tuple(val)
    if isinstance(current, int) and not isinstance(current, bool) and isinstance(val, str):
        return int(val)
    if isinstance(current, float) and isinstance(val, (str, int)):
        return float(val)
    return val


def default_config() -> Config:
    return Config()
