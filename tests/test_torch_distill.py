"""Heatmap knowledge distillation in the port (the `teacher` of
engine/train_state.make_heatmap_train_step, Trainer._build_teacher)
against the JAX package's `teacher_apply` step on the CPU.

Student: the SimpleBaseline-R18 of tests/test_torch_train.py (64x64, 4
keypoints); teacher: the width-8 "hrnet_t8" of tests/test_torch_hrnet.py;
both flax inits carried across by the converters, float32. Three
augmented steps (device affine + jitter, the port given JAX's draws) at
tests/test_torch_train.py's bounds: the first loss rtol 1e-4, every
loss, task loss and distillation loss rtol 1e-3, every grad_norm rtol
2e-2, parameters and statistics after 3 SGD steps within 5e-3 of each
tensor's largest |value| (see that file for why the whole-step bounds
are wider than its components').
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_heatmap_train_step as j_train_step
from tpupose.losses.heatmap import joints_mse_loss as j_mse
from tpupose.models.backbones import hrnet as jhrnet
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_train_step)
from tpupose_torch.losses.heatmap import joints_mse_loss
from tpupose_torch.models.backbones.hrnet import HRNetPose
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.utils.convert import (from_flax_hrnet,
                                         from_flax_simple_baseline)

from test_torch_model import _randomize_bn
from test_torch_quant import one_torch_thread, tiny_spec  # noqa: F401
from test_torch_train import AUG, B, HW, K, _batch, _jax_draws

T = torch.from_numpy
W = 0.5                                  # the distill weight


@pytest.fixture(scope="module")
def run(tiny_spec):
    """3 distilled SGD steps of JAX's jitted step and of the port's from
    the same inits; returns the per-step metrics of both, the initial
    and JAX's final student state dicts, the port's state and teacher,
    and the teacher's initial state dict."""
    sample = jnp.zeros((1, *HW, 3), jnp.float32)
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), sample, train=False)
    v = _randomize_bn(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), v), np.random.RandomState(1))
    jt = jhrnet.HRNetPose(variant="hrnet_t8", num_keypoints=K,
                          dtype=jnp.float32)
    tv = jax.jit(jt.init, static_argnames="train")(
        jax.random.PRNGKey(7), sample, train=False)
    tv = _randomize_bn(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), tv), np.random.RandomState(8))

    kw = dict(name="sgd", lr=0.01, head_lr=0.02, momentum=0.9)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0)
    state = create_train_state(jm, jax.random.PRNGKey(0), sample, tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))

    init_sd = from_flax_simple_baseline(v)
    model = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=torch.float32,
                           device="cpu", param_dtype=torch.float32)
    model.load_state_dict(init_sd)
    teacher = HRNetPose("hrnet_t8", K, dtype=torch.float32, device="cpu")
    teacher_sd = from_flax_hrnet(tv)
    teacher.load_state_dict(teacher_sd)
    teacher.requires_grad_(False)
    opt = make_optimizer(OptimizerConfig(**kw), model.named_parameters(),
                         is_head=lambda n: not is_backbone_path(n),
                         grad_clip_norm=10.0)
    tstate = TrainState(model, opt)

    batch = _batch()
    jstep = j_train_step(lambda p, t, w: j_mse(p, t, w), **AUG,
                         teacher_apply=jt.apply, distill_weight=W)
    tstep = make_heatmap_train_step(lambda p, t, w: joints_mse_loss(p, t, w),
                                    **AUG, teacher=teacher,
                                    distill_weight=W)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    keys = ("loss", "task_loss", "kd_loss", "grad_norm")
    steps = []
    for t in range(3):
        state, jmet = jstep(state, jb,
                            jax.tree_util.tree_map(jnp.asarray, tv))
        aff, jit = _jax_draws(AUG["jitter_seed"], t, B, 30.0, 0.25, 0.2)
        tmet = tstep(tstate, tb, draws={"affine": aff, "jitter": jit})
        steps.append(({k: float(jmet[k]) for k in keys},
                      {k: tmet[k].item() for k in keys}))
    want = from_flax_simple_baseline({
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats)})
    return steps, init_sd, want, tstate, teacher, teacher_sd


def test_distilled_step_matches_jax(run):
    steps, init, want, tstate, _, _ = run
    for t, (j, p) in enumerate(steps):
        print(f"step {t}: " + ", ".join(
            f"{k} rel {abs(p[k] / j[k] - 1):.3g}" for k in j))
        for k in ("loss", "task_loss", "kd_loss"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4 if t == 0
                                       else 1e-3, err_msg=k)
        np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=2e-2)
        np.testing.assert_allclose(p["loss"], (1 - W) * p["task_loss"]
                                   + W * p["kd_loss"], rtol=1e-6)
        assert p["kd_loss"] > 0 and p["task_loss"] > 0
    got = tstate.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].numpy(), w.numpy()
        assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max(), k
        assert not np.array_equal(w, init[k].numpy()), k


def test_teacher_is_frozen_and_in_eval_mode(run):
    """The teacher's weights and running statistics are as they were
    after the three steps (eval-mode forward, no graph), and the step
    leaves it in eval mode."""
    _, _, _, _, teacher, teacher_sd = run
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_sd[k]), k


# -- the Trainer ---------------------------------------------------------------

def _write_cfg(path, **over):
    """A yaml (JSON is YAML) of a heatmap model at 64x64, 4 keypoints."""
    d = {"model": {"name": "simple_baseline", "backbone": "resnet18",
                   "num_keypoints": K, "heatmap_size": [16, 16],
                   "deconv_channels": [32, 32, 32]},
         "data": {"image_size": [64, 64], "device_affine": True},
         "train": {"batch_size": 8, "epochs": 1, "warmup_epochs": 0,
                   "mixed_precision": False, "log_interval": 100}}
    for k, v in over.items():
        sec, key = k.split(".")
        d.setdefault(sec, {})[key] = v
    path.write_text(json.dumps(d))
    return str(path)


@pytest.fixture(scope="module")
def teacher_ckpt(tiny_spec, tmp_path_factory):
    """An hrnet_t8 teacher config and a checkpoint of it (best slot too)
    with weights moved off the Builder's init."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("teacher")
    tcfg_path = _write_cfg(root / "teacher.yaml", **{
        "model.name": "hrnet", "model.backbone": "hrnet_t8",
        "train.ema_decay": 0.9})
    tcfg = load_config(tcfg_path)
    b = Builder(tcfg, "cpu")
    m = b.model()
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    st = TrainState(m, b.optimizer(m, 1), ema_decay=0.9)
    ckpt = str(root / "ckpt")
    CheckpointManager(ckpt).save(5, st, metric=1.0, force=True)
    return tcfg_path, ckpt, {k: v.clone() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("suffix", ["", "@best"])
def test_trainer_distills_from_a_checkpoint(teacher_ckpt, tmp_path, suffix):
    """Trainer with train.distill_cfg / distill_ckpt (the periodic and
    the @best slot): the teacher holds the checkpoint's raw weights,
    frozen in eval mode on the trainer's device; an epoch of distilled
    steps logs finite task and distillation losses and leaves the
    teacher as it was."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.trainer import Trainer

    tcfg_path, ckpt, want = teacher_ckpt
    cfg = load_config(_write_cfg(tmp_path / "student.yaml"), {
        "train.distill_cfg": tcfg_path,
        "train.distill_ckpt": ckpt + suffix,
        "train.output_dir": str(tmp_path / "out")})
    tr = Trainer(cfg, device="cpu")
    t = tr.teacher
    assert isinstance(t, HRNetPose) and not t.training
    assert not any(p.requires_grad for p in t.parameters())
    assert next(t.parameters()).device == tr.device
    for k, v in t.state_dict().items():
        assert torch.equal(v, want[k]), k
    db = next(iter(tr._prefetched(tr.train_loader)))
    m = tr.train_step(tr.state, db)
    assert {"loss", "task_loss", "kd_loss", "grad_norm"} <= set(m)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert np.isfinite(tr.iter_one_epoch(0))
    for k, v in t.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_trainer_without_a_checkpoint_keeps_a_random_teacher(
        teacher_ckpt, tmp_path):
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.trainer import Trainer

    tcfg_path, _, want = teacher_ckpt
    cfg = load_config(_write_cfg(tmp_path / "student.yaml"), {
        "train.distill_cfg": tcfg_path,
        "train.output_dir": str(tmp_path / "out")})
    tr = Trainer(cfg, device="cpu")
    assert any(not torch.equal(v, want[k])
               for k, v in tr.teacher.state_dict().items())


@pytest.mark.parametrize("over,match", [
    ({"model.name": "simcc", "loss.name": "simcc_kl"}, "heatmap-family"),
    ({"model.heatmap_size": [8, 8]}, "heatmap grid"),
    ({"model.num_keypoints": 5}, "heatmap grid"),
    ({"data.image_size": [64, 48], "model.heatmap_size": [16, 16]},
     "input size")], ids=["family", "grid", "keypoints", "input"])
def test_trainer_refuses_an_incompatible_teacher(tmp_path, over, match):
    """JAX's three refusals: a teacher outside the heatmap families, one
    on another heatmap grid or keypoint count, one on another input
    size."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.trainer import Trainer

    tcfg_path = _write_cfg(tmp_path / "teacher.yaml", **over)
    cfg = load_config(_write_cfg(tmp_path / "student.yaml"), {
        "train.distill_cfg": tcfg_path,
        "train.output_dir": str(tmp_path / "out")})
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu")
