"""DINOv3Pose training and evaluation through tpupose_torch held against
the JAX package on the CPU, float32, at 64x64 on the small models of
tests/test_torch_dinov3.py (ConvNeXt "atto" and ViT "small", neck (48,
96, 192), 4 keypoints, 7 classes), flax's init with non-trivial
BatchNorm statistics and O(1) ViT layer scales carried across by
from_flax_dinov3_pose, on SyntheticYoloPoseDataset samples:

  - (a) three AdamW steps of make_yolo_train_step (lr 1e-3 for the
    backbone, head_lr 1e-2 for the rest, weight decay, clip 10) against
    tpupose's jitted step: ConvNeXt atto with pose_compute and a frozen
    backbone; ViT small with v8_pose (reg_max 16) and the backbone
    trained; and one step with the mosaic on JAX's draws;
  - (b) Trainer.validate() on a padded tail batch, the port's running
    statistics unchanged by it, and Trainer.evaluate() (val_loss and
    evaluate_yolo's OKS-AP) against JAX's Trainer on the same weights;
  - (c) the three DINOv3Pose yamls through Trainer, frozen and not, an
    exact resume, and cli.train --test --device cpu.

Each tolerance is stated where it is used, with its reason.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_yolo_train_step as j_yolo_step
from tpupose.losses.pose_loss import ComputeLoss as JComputeLoss
from tpupose.losses.v8 import v8PoseLoss as Jv8PoseLoss
from tpupose.models.dinov3_pose import DINOv3Pose as JDINOv3Pose
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.data.synthetic import SyntheticYoloPoseDataset
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import TrainState, make_yolo_train_step
from tpupose_torch.losses import ComputeLoss, v8PoseLoss
from tpupose_torch.models.dinov3_pose import DINOv3Pose
from tpupose_torch.utils.convert import from_flax_dinov3_pose

from test_torch_dinov3 import NECK, flax_dinov3
from test_torch_yolo_loss import _jax_mosaic_draws
from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
B, HW = 4, (64, 64)
LR, HEAD_LR, WD = 1e-3, 1e-2, 1e-4
MOSAIC_SEED = 7


def _yolo_batch(n=B, seed=5):
    ds = SyntheticYoloPoseDataset(n, HW, 4, 7, max_instances=8, seed=seed)
    keys = (("images", "image"), ("boxes", "boxes"), ("classes", "classes"),
            ("keypoints", "keypoints"), ("instance_mask", "instance_mask"))
    return {k: np.stack([ds[i][s] for i in range(n)]) for k, s in keys}


def _stats_and_params(sd):
    return [k for k in sd if not k.endswith("num_batches_tracked")]


def _favour_small_boxes(tree, reg_max):
    """The DFL box convs' biases (the head's 1x1 convs to 4 reg_max
    channels) at -0.8 bin: the expected distance is ~0.8 grid units a
    side, so that the predicted boxes overlap the synthetic GTs and the
    assigner finds positives (flax's zero bias puts every box at 7.5
    grid units a side, where IoU^6 is below the assigner's eps)."""
    for node in tree.values():
        if not isinstance(node, dict):
            continue
        k = node.get("kernel")
        if k is not None and k.shape[:2] == (1, 1) \
                and k.shape[-1] == 4 * reg_max and "bias" in node:
            node["bias"] = np.tile(-0.8 * np.arange(reg_max, dtype=np.float32),
                                   4)
        else:
            _favour_small_boxes(node, reg_max)


def _run_steps(backbone, reg_max, loss_name, frozen, mosaic_prob=0.0,
               n_steps=3):
    """n_steps of tpupose's jitted yolo step and of the port's from the
    same weights. Returns the per-step (jax metrics, port metrics), the
    initial state dict, JAX's final variables as a port state dict, JAX's
    final backbone params beside its initial ones, and the port model."""
    _, v = flax_dinov3(backbone, reg_max)
    if reg_max:
        _favour_small_boxes(v["params"], reg_max)
    jm = JDINOv3Pose(backbone=backbone, num_keypoints=4, num_classes=7,
                     neck_channels=NECK, reg_max=reg_max,
                     freeze_backbone=frozen, dtype=jnp.float32)
    kw = dict(name="adamw", lr=LR, head_lr=HEAD_LR, weight_decay=WD)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          is_frozen=j_is_backbone if frozen else None,
                          grad_clip_norm=10.0)
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               jnp.zeros((1, *HW, 3)), tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))

    init_sd = from_flax_dinov3_pose(v)
    model = DINOv3Pose(backbone, 4, 7, NECK, reg_max=reg_max,
                       freeze_backbone=frozen, dtype=torch.float32,
                       device="cpu")
    model.load_state_dict(init_sd)
    opt = make_optimizer(OptimizerConfig(**kw), model.named_parameters(),
                         is_head=lambda n: not is_backbone_path(n),
                         is_frozen=is_backbone_path if frozen else None,
                         grad_clip_norm=10.0)
    tstate = TrainState(model, opt)

    if loss_name == "v8_pose":
        jloss, tloss = Jv8PoseLoss(4, 7, reg_max=reg_max), \
            v8PoseLoss(4, 7, reg_max=reg_max)
    else:
        kl = dict(num_keypoints=4, num_classes=7, kpt_loss_type="oks")
        jloss, tloss = JComputeLoss(**kl), ComputeLoss(**kl)
    jstep = j_yolo_step(jloss, mosaic_prob=mosaic_prob,
                        mosaic_seed=MOSAIC_SEED)
    tstep = make_yolo_train_step(tloss, mosaic_prob=mosaic_prob,
                                 mosaic_seed=MOSAIC_SEED)
    batch = _yolo_batch()
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    out = []
    for t in range(n_steps):
        state, jmet = jstep(state, jb)
        draws = None
        if mosaic_prob > 0:
            rng = jax.random.fold_in(jax.random.PRNGKey(MOSAIC_SEED), t)
            draws = {"mosaic": _jax_mosaic_draws(rng, B)}
        tmet = tstep(tstate, tb, draws=draws)
        out.append(({k: float(x) for k, x in jmet.items()},
                    {k: x.item() for k, x in tmet.items()}))
        if t == 0:
            first = (_port_sd(state), {k: x.clone() for k, x in
                                       model.state_dict().items()})
    jbb = [(k, v["params"][k], state.params[k]) for k in v["params"]
           if j_is_backbone((k,))]
    return out, init_sd, _port_sd(state), jbb, model, first


def _port_sd(state):
    """A JAX train state's variables as a port state dict."""
    return from_flax_dinov3_pose({
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats)})


@pytest.fixture(scope="module")
def atto_frozen():
    return _run_steps("dinov3_convnext_atto", 0, "pose_compute", True)


@pytest.fixture(scope="module")
def vit_v8_unfrozen():
    return _run_steps("dinov3_vit_small", 16, "v8_pose", False)


def _check_steps(run, label):
    """The first step: loss, every part and grad_norm rtol 1e-4 (float32
    through the neck's train-mode BatchNorm), and the running statistics
    it leaves within 1e-5 of each tensor's max |value| (the same forward).
    Later steps: the loss and every part rtol 2e-2, grad_norm printed;
    every parameter within 2 * lr * steps of JAX's after each step
    checked (tests/test_torch_train.py's Adam bounds). Adam's first
    updates are about lr * sign(g), and the gradient of a conv weight in
    front of a train-mode BatchNorm has elements that cancel to near 0,
    whose float32 sign differs with the summation order (torch's own, on
    another CPU thread count, too), so the two trajectories part after
    the first update: the later grad_norm and statistics are printed, not
    bounded. Prints every reading."""
    steps, init, want_sd, jbb, model, (j_first, t_first) = run
    for t, (jm, tm) in enumerate(steps):
        assert set(tm) == set(jm), (set(tm), set(jm))
        print(f"{label} step {t}: " + ", ".join(
            f"{k} rel {abs(tm[k] / jm[k] - 1) if jm[k] else tm[k]:.3g}"
            for k in sorted(jm)))
        for k in jm:
            assert k == "mosaic_dropped" or jm[k] > 0, (t, k)
            assert np.isfinite(tm[k]), (t, k)
            if t and k == "grad_norm":
                continue
            np.testing.assert_allclose(tm[k], jm[k],
                                       rtol=2e-2 if t else 1e-4,
                                       atol=1e-7, err_msg=f"step {t} {k}")
    params = {n for n, _ in model.named_parameters()}
    got = model.state_dict()
    states = [(1, t_first, j_first)]
    if len(steps) > 1:
        states.append((len(steps), got, want_sd))
    for n_steps, g_sd, w_sd in states:
        worst = {"params": 0.0, "stats": 0.0}
        for k in _stats_and_params(w_sd):
            d = np.abs(g_sd[k].numpy() - w_sd[k].numpy()).max()
            if k in params:
                lr = LR if is_backbone_path(k) else HEAD_LR
                worst["params"] = max(worst["params"], d / lr)
                assert d <= 2 * lr * n_steps, (k, d)
            else:
                d /= np.abs(w_sd[k].numpy()).max()
                worst["stats"] = max(worst["stats"], d)
                assert n_steps > 1 or d <= 1e-5, (k, d)
        print(f"{label} after {n_steps} steps: params max |diff| / lr "
              f"{worst['params']:.3g}, statistics max rel "
              f"{worst['stats']:.3g}")
    return got, init, want_sd, jbb


def test_frozen_convnext_pose_compute_steps_match_jax(atto_frozen):
    """ConvNeXt atto, pose_compute (oks), frozen backbone: the loss, its
    cls/kpt/vis parts and grad_norm as _check_steps bounds them; the
    backbone unchanged in both, bit for bit, and every other parameter
    moved."""
    got, init, want_sd, jbb = _check_steps(atto_frozen, "atto frozen")
    names = [n for n, _ in atto_frozen[4].named_parameters()]
    bb = [n for n in names if is_backbone_path(n)]
    assert bb
    for n in bb:
        assert torch.equal(got[n], init[n]), n
    for k, a, b in jbb:
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for n in names:
        if not is_backbone_path(n):
            assert not torch.equal(got[n], init[n]), n


def test_unfrozen_vit_v8_steps_match_jax(vit_v8_unfrozen):
    """ViT small, v8_pose at reg_max 16, backbone trained at lr and the
    rest at head_lr: the loss, its box/cls/dfl/kpt/vis parts and
    grad_norm as _check_steps bounds them; the backbone moved in both."""
    got, init, _, jbb = _check_steps(vit_v8_unfrozen, "vit v8 unfrozen")
    assert any(not torch.equal(got[n], init[n]) for n in got
               if is_backbone_path(n))
    assert any(not np.array_equal(np.asarray(x), np.asarray(y))
               for _, a, b in jbb for x, y in zip(
                   jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def test_mosaic_step_matches_jax():
    """One step with the mosaic on every image (JAX's draws handed to the
    port): loss, parts and grad_norm rtol 1e-4 (_check_steps' first
    step), `mosaic_dropped` exactly."""
    run = _run_steps("dinov3_convnext_atto", 0, "pose_compute", True,
                     mosaic_prob=1.0, n_steps=1)
    _check_steps(run, "atto mosaic")
    (jm, tm), = run[0]
    assert "mosaic_dropped" in tm and tm["mosaic_dropped"] == \
        jm["mosaic_dropped"]


def test_step_draws_are_seeded_by_the_step():
    """draws_for(step) comes from a generator seeded by (seed, step): the
    same step gives the same draws (an exact resume), another step
    others; without mosaic there are none."""
    step = make_yolo_train_step(None, mosaic_prob=0.5, mosaic_seed=3)
    a, b = step.draws_for(4, 8, "cpu"), step.draws_for(4, 8, "cpu")
    c = step.draws_for(5, 8, "cpu")
    assert all(torch.equal(a["mosaic"][k], b["mosaic"][k]) for k in a["mosaic"])
    assert not torch.equal(a["mosaic"]["centers"], c["mosaic"]["centers"])
    assert make_yolo_train_step(None).draws_for(0, 8, "cpu") == {}


# -- (b) validate and evaluate against JAX's Trainer ---------------------------

YAML = "tpupose/configs/method/dinov3_pose.yaml"
TINY = ("model.backbone=dinov3_convnext_atto", "model.neck_channels=[48,96,192]",
        "data.image_size=[64,64]", "train.mixed_precision=false",
        "train.batch_size=16", "train.log_interval=100",
        "eval.batch_size=24", "eval.conf_threshold=0.005")


def _cfgs(yaml, *over):
    from tpupose.configs import load_config as jload
    from tpupose_torch.configs import parse_args, update_config
    from tpupose_torch.configs.default import default_config

    args = parse_args(["--cfg", yaml, "--device", "cpu", *over])
    d = dict(o.split("=", 1) for o in over)
    return update_config(default_config(), args), jload(yaml, d)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """JAX's Trainer and the port's on the tiny ConvNeXt config (32 valid
    samples in batches of 24: the second is padded with 16 rows), the
    port's weights and statistics JAX's, trained one step apart from the
    init so the BatchNorm statistics are not the defaults."""
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.trainer import Trainer

    out = tmp_path_factory.mktemp("yolo_eval")
    cfg, jcfg = _cfgs(YAML, *TINY, f"train.output_dir={out}")
    jt = JTrainer(jcfg)
    jt.state, _ = jt.train_step(jt.state, jt._prepare_batch(
        next(iter(jt.train_loader))))
    pt = Trainer(cfg, device="cpu")
    pt.model.load_state_dict(from_flax_dinov3_pose(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}))
    return jt, pt


def test_validate_on_a_padded_tail_matches_jax(trainers):
    """validate(): the val loss over 32 samples (the tail batch padded,
    its padding rows out of every term) rtol 1e-5 of JAX's (float32, the
    train-mode BatchNorm on the batch statistics); the port's running
    statistics and every parameter bit-unchanged by it."""
    jt, pt = trainers
    assert pt.family == "yolo"
    pads = [b.get("pad_mask") for b in pt.valid_loader]
    assert [int(p.sum()) for p in pads] == [24, 8]
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    want, got = jt.validate(), pt.validate()
    print(f"val loss: port {got!r}, JAX {want!r}")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_evaluate_matches_jax(trainers, monkeypatch):
    """evaluate(): val_loss and evaluate_yolo's OKS-AP (YoloPosePredictor
    at conf 0.005, box NMS, OKS-NMS, OKS-AP over 7 classes) within 1e-5
    of JAX's Trainer on the same weights. A few random-init steps score
    AP 0, so what OKS-AP is handed per image is held too: the detections
    OKS-NMS keeps (equal count and classes, keypoints within 1e-3 px,
    scores rtol 1e-5: float32 forwards of the same weights; the areas,
    products of keypoint extents of about 0.1 px here, within 1e-5 px^2)
    and the GT (equal). OKS-NMS suppresses nothing on these spread-out
    random detections; test_torch_yolo_loss.py holds it where it does."""
    import tpupose.metrics.oks_ap as jap
    import tpupose_torch.metrics.oks_ap as pap

    jt, pt = trainers
    seen = {}
    for name, mod in (("jax", jap), ("port", pap)):
        calls = seen[name] = []
        update = mod.OKSAP.update

        def record(self, *a, _update=update, _calls=calls, **kw):
            _calls.append((a, kw))
            return _update(self, *a, **kw)

        monkeypatch.setattr(mod.OKSAP, "update", record)
    want, got = jt.evaluate(), pt.evaluate()
    print(f"evaluate: port {got}, JAX {want}")
    assert {"val_loss", "mAP", "mAP50", "mAP75"} <= set(got)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * max(1.0, abs(w)), (k, got[k], w)
    assert len(seen["port"]) == len(seen["jax"]) == 32
    kept = []
    for (ga, gk), (wa, wk) in zip(seen["port"], seen["jax"]):
        (pk, ps, gkp, gv, garea), (wpk, wps, wgkp, wgv, wgarea) = ga, wa
        assert len(pk) == len(wpk)
        kept.append(len(pk))
        np.testing.assert_allclose(pk, wpk, atol=1e-3)
        np.testing.assert_allclose(ps, wps, rtol=1e-5)
        np.testing.assert_allclose(gk["pred_area"], wk["pred_area"],
                                   atol=1e-5)
        np.testing.assert_array_equal(gk["pred_cls"], wk["pred_cls"])
        for a, b in ((gkp, wgkp), (gv, wgv), (garea, wgarea),
                     (gk["gt_cls"], wk["gt_cls"]),
                     (gk["gt_valid"], wk["gt_valid"])):
            np.testing.assert_array_equal(a, b)
    print(f"detections kept per image (OKS-NMS): {kept}")
    assert sum(kept) > 0


# -- (c) the configs through Trainer and the CLI ---------------------------------

@pytest.mark.parametrize("yaml,over", [
    ("dinov3_vitpose.yaml", ("model.backbone=dinov3_vit_small",)),
    ("dinov3_pose.yaml", ("model.freeze_backbone=false",
                          "data.mosaic_prob=0.5")),
    ("dinov3_pose_v8.yaml", ())], ids=["vit", "convnext-unfrozen-mosaic",
                                       "convnext-v8"])
def test_trainer_trains_the_dinov3_configs(yaml, over, tmp_path):
    """Each DINOv3Pose yaml (tiny widths at 64x64) trains one epoch of 8
    steps through Trainer.train() without a raise; every logged loss part
    is finite, validate() is finite, and a fresh Trainer resumes the
    saved checkpoint to the same step with equal parameters, statistics
    and next step."""
    from tpupose_torch.engine.trainer import Trainer

    cfg, _ = _cfgs(f"tpupose/configs/method/{yaml}", *TINY, *over,
                   "train.epochs=1", "train.warmup_epochs=0",
                   f"train.output_dir={tmp_path}")
    tr = Trainer(cfg, device="cpu")
    metrics = []
    step = tr.train_step
    tr.train_step = lambda s, b, d=None: metrics.append(step(s, b, d)) \
        or metrics[-1]
    tr.train()
    assert tr.state.step == tr.steps_per_epoch == 8
    parts = {"pose_compute": {"cls", "kpt", "vis"},
             "v8_pose": {"box", "cls", "dfl", "kpt", "vis"}}[cfg.loss.name]
    want = {"loss", "grad_norm"} | {f"loss_{p}" for p in parts}
    if cfg.data.mosaic_prob > 0:
        want.add("mosaic_dropped")
    for m in metrics:
        assert set(m) == want
        assert all(np.isfinite(v.item()) for v in m.values())
    assert np.isfinite(tr.validate())
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.load_checkpoint() == tr.state.step == tr2.state.step
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    batch = next(iter(tr.train_loader))
    m1 = step(tr.state, tr._prepare_batch(batch))
    m2 = tr2.train_step(tr2.state, tr2._prepare_batch(batch))
    for k in m1:
        assert m1[k].item() == m2[k].item(), k


def test_cli_test_prints_validate_and_evaluate(tmp_path, capsys):
    """cli.train --test --device cpu on the tiny ConvNeXt config prints
    the validation loss and evaluate_yolo's metrics."""
    from tpupose_torch.cli.train import main

    assert main(["--cfg", YAML, "--device", "cpu", "--test", *TINY,
                 f"train.output_dir={tmp_path}"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "validation loss:" in ln][-1]
    got = dict(re.findall(r"(\w+)[=:] ?(-?[\d.]+)", line))
    assert {"loss", "val_loss", "mAP", "mAP50"} <= set(got)
    assert np.isfinite(float(got["loss"]))


@pytest.mark.parametrize("loss", ["coord_mse", "rle", "ae", "simcc_kl"])
def test_remaining_losses_raise_with_their_item(loss, tmp_path):
    """The losses of ROADMAP Queue A item 9, which raised here citing the
    item until their families were ported, now build in the Builder and
    pick their family in Trainer (as JAX's Trainer picks it from
    loss.name); an unknown loss raises in both."""
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.trainer import Trainer

    cfg, _ = _cfgs(YAML, *TINY, f"loss.name={loss}",
                   f"train.output_dir={tmp_path}")
    assert callable(Builder(cfg, "cpu").loss())
    family = {"coord_mse": "regression", "rle": "rle", "ae": "bottom_up",
              "simcc_kl": "simcc"}[loss]
    assert Trainer(cfg, device="cpu").family == family
    bad, _ = _cfgs(YAML, *TINY, "loss.name=no_such_loss",
                   f"train.output_dir={tmp_path}")
    with pytest.raises(ValueError, match="unknown loss"):
        Builder(bad, "cpu").loss()
    with pytest.raises(ValueError, match="unknown loss"):
        Trainer(bad, device="cpu")
