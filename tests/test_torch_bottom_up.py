"""Bottom-up AE pose in the port (losses/ae.py, ops/ae_decode.py,
models/bottom_up.py, utils/convert.from_flax_bottom_up,
make_bottom_up_train_step, BottomUpPredictor, Trainer.evaluate_bottom_up,
the Builder) held against the JAX package on the CPU, float32, on numpy
seeded inputs and flax weights carried across by the converter.

Trunks: the width-8 "hrnet_t8" (tests/test_torch_quant.py) and a
ResNet-18 with deconvs of 32, at 64x64 (16x16 maps), K = 4 (17 in the
decode tests). Tolerances, with their reasons:
  - the targets, the tag gather and the decode: equal (the same float32
    operations; the peak order is JAX's top-k order, ties to the lower
    index), but for the person scores, a mean (1e-6);
  - the loss parts: float32 sums in another order, rtol 3e-6; gradients
    elementwise, 1e-6 of their max;
  - the forwards: 1e-4 of the range; the predictor's person arrays:
    coordinates and scores within 1e-4 of JAX's, the same persons;
  - the train steps: the first loss 1e-4, the second 1e-3, grad norms
    2e-2, the state (the port's float32 run and JAX's) within 1e-4 of the
    port's own float64 run;
  - the int8 scales: 1e-5 relative (float32 maxima of another order);
  - evaluate(): every metric within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.predictor import BottomUpPredictor as JPredictor
from tpupose.engine.train_state import TrainState as JState
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_bottom_up_train_step as j_step
from tpupose.losses import ae as jae
from tpupose.models.bottom_up import BottomUpPose as JBottomUp
from tpupose.ops import ae_decode as jdec
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.predictor import BottomUpPredictor
from tpupose_torch.engine.train_state import (TrainState,
                                              make_bottom_up_train_step)
from tpupose_torch.losses import ae as pae
from tpupose_torch.models.bottom_up import BottomUpPose
from tpupose_torch.ops import ae_decode as pdec
from tpupose_torch.utils.convert import from_flax_bottom_up

from test_torch_model import _randomize_bn
from test_torch_quant import one_torch_thread, tiny_spec  # noqa: F401

T = torch.from_numpy
K = 4
HW = (64, 64)
HM = (16, 16)


def _instances(B=3, M=5, seed=0):
    """Normalized (x, y, vis) instances: padded slots (mask 0), an
    unlabelled joint, joints off the map on either side, one image with
    no instance at all."""
    rs = np.random.RandomState(seed)
    kp = np.concatenate([rs.uniform(-0.05, 1.05, (B, M, K, 2)),
                         (rs.uniform(size=(B, M, K, 1)) > 0.2)], -1)
    kp = kp.astype(np.float32)
    mask = np.zeros((B, M), np.float32)
    mask[0, :3] = 1
    mask[1, :5] = 1
    return kp, mask


def test_targets_and_tags_match_jax():
    kp, mask = _instances()
    got = pae.multi_person_heatmaps(T(kp), T(mask), HM, 2.0)
    want = jae.multi_person_heatmaps(jnp.asarray(kp), jnp.asarray(mask), HM,
                                     2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    tags = np.random.RandomState(1).normal(0, 1, (3, *HM, K)).astype(
        np.float32)
    gv, gm = pae.gather_tags(T(tags), T(kp), T(mask))
    wv, wm = jae.gather_tags(jnp.asarray(tags), jnp.asarray(kp),
                             jnp.asarray(mask))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert 0 < gm.sum() < (mask[..., None] * kp[..., 2]).sum()


def test_ae_loss_parts_and_gradients_match_jax():
    kp, mask = _instances(seed=2)
    pred = np.random.RandomState(3).normal(0, 0.5, (3, *HM, 2 * K)).astype(
        np.float32)

    def jloss(p):
        loss, parts = jae.ae_loss(p, kp, mask, sigma=2.0, tag_sigma=1.0,
                                  pull_weight=0.5, push_weight=0.25)
        return loss, parts

    (jv, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pred))
    p = T(pred).requires_grad_(True)
    v, parts = pae.ae_loss(p, T(kp), T(mask), sigma=2.0, tag_sigma=1.0,
                           pull_weight=0.5, push_weight=0.25)
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=3e-6)
    assert sorted(parts) == sorted(jparts) == ["hm_loss", "pull", "push"]
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   rtol=3e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(p.grad.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    assert float(jparts["pull"]) > 0 and float(jparts["push"]) > 0


# -- the decode -----------------------------------------------------------------

def _peaks_equal(hm, P):
    got = pdec.find_peaks(T(hm), P)
    want = jdec.find_peaks(jnp.asarray(hm), P)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


def test_find_peaks_breaks_a_plateau_and_keeps_jax_order_on_ties():
    """A 2x2 plateau gives one peak (the highest linear index); equal
    positive peaks (as on int8-served maps) come in JAX's top-k order,
    lower flat index first; a flat map's zeros too."""
    hm = np.zeros((2, 3, 12, 10), np.float32)
    hm[0, 0, 3:5, 3:5] = 0.8                     # plateau
    for y, x in ((1, 1), (6, 8), (9, 2), (10, 7), (2, 8)):
        hm[0, 1, y, x] = 0.5                     # equal peaks
    hm[1, 0] = np.random.RandomState(4).randint(0, 4, (12, 10)) / 4.0
    hm[1, 1, 5, 5] = hm[1, 1, 0, 9] = 1.0
    coords, scores, idx = _peaks_equal(hm, 6)
    assert scores[0, 0].tolist()[:2] == [0.800000011920929, 0.0]
    assert idx[0, 0, 0] == 4 * 10 + 4
    assert scores[0, 1].tolist()[:5] == [0.5] * 5
    assert idx[0, 1, :5].tolist() == sorted(idx[0, 1, :5].tolist())


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_find_peaks_on_lattice_maps_matches_jax(seed):
    """Maps on an int8-like lattice: many exact ties in and across 3x3
    windows."""
    rs = np.random.RandomState(seed)
    hm = (rs.randint(0, 6, (2, 17, 16, 16)) / 5.0).astype(np.float32)
    _peaks_equal(hm, 30)


def _separated(B=2, P=4, seed=8):
    """Heatmaps with one Gaussian per person and joint, each person's
    tags near its own value (persons 2 apart, noise 0.1)."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:HM[0], 0:HM[1]].astype(np.float32)
    hm = np.zeros((B, 17, *HM), np.float32)
    tg = rs.normal(0, 3, (B, 17, *HM)).astype(np.float32)
    for b in range(B):
        for p in range(P):
            for k in range(17):
                x, y = rs.randint(1, HM[1] - 1), rs.randint(1, HM[0] - 1)
                g = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / 2.0) \
                    * rs.uniform(0.5, 1.0)
                hm[b, k] = np.maximum(hm[b, k], g)
                tg[b, k, y, x] = 2.0 * p + rs.normal(0, 0.1)
    return hm, tg


@pytest.mark.parametrize("case", ["random", "separated"])
def test_decode_ae_matches_jax(case):
    """The whole grouping: coordinates, scores and person masks equal
    JAX's, person scores within 1e-6; on separated tags the persons are
    found."""
    if case == "random":
        rs = np.random.RandomState(9)
        hm = rs.uniform(0, 1, (2, 17, *HM)).astype(np.float32)
        tg = rs.normal(0, 1, (2, 17, *HM)).astype(np.float32)
    else:
        hm, tg = _separated()
    got = pdec.decode_ae(T(hm), T(tg), max_people=6)
    want = jdec.decode_ae(jnp.asarray(hm), jnp.asarray(tg), max_people=6)
    assert sorted(got) == sorted(want)
    for k in ("coords", "scores", "person_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # a mean over the joints: float32 sums in another order
    np.testing.assert_allclose(got["person_scores"].numpy(),
                               np.asarray(want["person_scores"]), rtol=1e-6)
    if case == "separated":
        assert got["person_mask"].sum(-1).min() >= 4


# -- the trunks -----------------------------------------------------------------

def _flax_bottom_up(backbone, seed=0):
    jm = JBottomUp(backbone=backbone, num_keypoints=K,
                   deconv_channels=(32, 32, 32), dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    return jm, _randomize_bn(v, np.random.RandomState(seed + 1))


def _port_bottom_up(backbone, v, dtype=torch.float32):
    tm = BottomUpPose(backbone, K, (32, 32, 32), dtype=dtype, device="cpu")
    tm.load_state_dict(from_flax_bottom_up(v))
    return tm


@pytest.mark.parametrize("backbone", ["hrnet_t8", "resnet18"])
def test_trunks_converter_and_forward_match_jax(backbone):
    jm, v = _flax_bottom_up(backbone, seed=3)
    tm = _port_bottom_up(backbone, v)
    paths = {}
    sd = from_flax_bottom_up(v, paths)
    assert set(sd) == set(tm.state_dict())
    assert sum(a.size for a in jax.tree_util.tree_leaves(v)) == sum(
        t.numel() for k, t in sd.items()
        if not k.endswith("num_batches_tracked"))
    assert set(paths) == {n for n, m in tm.named_modules() if isinstance(
        m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))}
    x = np.random.RandomState(4).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jm.apply(v, a, train=False))(x))
    got = tm(T(x)).detach().numpy()
    assert got.shape == want.shape == (2, *HM, 2 * K)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    hm, tg = BottomUpPose.split(T(want))
    jhm, jtg = JBottomUp.split(jnp.asarray(want))
    np.testing.assert_array_equal(hm.numpy(), np.asarray(jhm))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jtg))


def test_final_conv_runs_in_float32_under_autocast():
    tm = BottomUpPose("hrnet_t8", K, dtype=torch.bfloat16, device="cpu",
                      param_dtype=torch.float32)
    seen = {}
    tm.final_layer.register_forward_hook(
        lambda m, a, o: seen.update(x=a[0].dtype, y=o.dtype))
    assert tm(torch.zeros(1, *HW, 3)).dtype == torch.float32
    assert seen == {"x": torch.float32, "y": torch.float32}


# -- the train step -------------------------------------------------------------

def _batch(B=4):
    kp, mask = _instances(B, 5, seed=10)
    mask[:, :2] = 1
    rs = np.random.RandomState(11)
    return {"images": rs.randint(0, 256, (B, *HW, 3)).astype(np.uint8),
            "keypoints": kp, "instance_mask": mask}


def test_train_steps_match_jax():
    """2 SGD steps (momentum 0.9, clip 10, lr 1e-2 / 2e-2) of the
    ResNet-18 trunk, tpupose's jitted step against the port's in float32
    and float64: the first loss and its parts rtol 1e-4, the second 1e-3,
    grad norms 2e-2; the state as the module docstring says. Printed
    with -s."""
    jm, v = _flax_bottom_up("resnet18")
    kw = dict(name="sgd", lr=1e-2, head_lr=2e-2, momentum=0.9)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0)
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               jnp.zeros((1, *HW, 3)), tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))
    loss_kw = dict(sigma=2.0, tag_sigma=1.0, pull_weight=1e-3,
                   push_weight=1e-3)
    jstep = j_step(lambda *a: jae.ae_loss(*a, **loss_kw))
    tstep = make_bottom_up_train_step(lambda *a: pae.ae_loss(*a, **loss_kw))
    ts = {}
    for dt in (torch.float32, torch.float64):
        m = _port_bottom_up("resnet18", v, dtype=dt)
        ts[dt] = TrainState(m, make_optimizer(
            OptimizerConfig(**kw), m.named_parameters(),
            is_head=lambda n: not is_backbone_path(n), grad_clip_norm=10.0))
    batch = _batch()
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    for t in range(2):
        state, jmet = jstep(state, jb)
        met = {dt: tstep(s, tb) for dt, s in ts.items()}[torch.float32]
        assert set(met) == set(jmet) == {"loss", "grad_norm", "hm_loss",
                                         "pull", "push"}
        rt = 1e-4 if t == 0 else 1e-3
        for k in ("loss", "hm_loss", "pull", "push"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                       rtol=rt, err_msg=k)
        np.testing.assert_allclose(met["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=2e-2)
    want = from_flax_bottom_up({"params": jax.device_get(state.params),
                                "batch_stats": jax.device_get(
                                    state.batch_stats)})
    got = {dt: s.model.state_dict() for dt, s in ts.items()}
    worst = {"port": 0.0, "jax": 0.0}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = got[torch.float64][k].double().numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        for name, tt in (("port", got[torch.float32][k].numpy()),
                         ("jax", w.numpy())):
            worst[name] = max(worst[name], np.abs(tt - ref).max() / scale)
    print(f"bottom-up state after 2 steps vs the port in float64: {worst}")
    assert worst["port"] <= 1e-4 and worst["jax"] <= 1e-4, worst


# -- BottomUpPredictor ----------------------------------------------------------

def _jstate(jm, v):
    return JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                  batch_stats=v["batch_stats"], opt_state=(),
                  apply_fn=jm.apply, tx=optax.sgd(0.0))


def _frames(n=3, seed=12):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("flip", [False, True], ids=["direct", "flip"])
def test_predictor_matches_jax(flip):
    """Forward (flip-averaged heatmaps with flip pairs), AE grouping and
    the stride-4 scaling: the same persons, coordinates within 1e-4 px
    and scores within 1e-4 of JAX's."""
    jm, v = _flax_bottom_up("resnet18", seed=13)
    tm = _port_bottom_up("resnet18", v)
    pairs = np.array([(1, 2)])
    kw = dict(max_people=8, score_threshold=0.1, tag_threshold=1.0,
              flip_test=flip, flip_pairs=pairs)
    want = JPredictor(_jstate(jm, v), **kw)(_frames())
    got = BottomUpPredictor(tm, device="cpu", **kw)(_frames())
    np.testing.assert_array_equal(got["person_mask"], want["person_mask"])
    assert got["person_mask"].sum() > 0
    np.testing.assert_allclose(got["coords"], want["coords"], atol=1e-4)
    for k in ("scores", "person_scores"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_predictor_int8():
    """eval.int8's intercept: the calibration scales equal JAX's through
    the converter's paths, and the int8 predictor is the AE decode of
    the port's quantized forward; flip without pairs is off."""
    from tpupose.ops.preprocess import normalize_images as j_norm
    from tpupose.ops.quant import calibrate as j_calibrate
    from tpupose_torch.ops.preprocess import normalize_images
    from tpupose_torch.ops.quant import quantized_apply

    jm, v = _flax_bottom_up("resnet18", seed=14)
    tm = _port_bottom_up("resnet18", v)
    frames = _frames(2, seed=15)
    paths = {}
    from_flax_bottom_up(v, paths)
    scales = BottomUpPredictor.calibrate_int8(tm, frames)
    want = j_calibrate(jm.apply, v, [frames], preprocess=j_norm,
                       train=False)
    assert set(scales) == set(paths)
    for name, s in scales.items():
        np.testing.assert_allclose(s, want[paths[name]], rtol=1e-5)
    pred = BottomUpPredictor(tm, quant_scales=scales, flip_test=True,
                             device="cpu")
    assert not pred.flip_test
    got = pred(frames)
    hm, tg = BottomUpPose.split(quantized_apply(
        tm, scales, normalize_images(T(frames))))
    ref = pdec.decode_ae(hm, tg, max_people=30)
    for k in ("scores", "person_scores", "person_mask"):
        np.testing.assert_array_equal(got[k], ref[k].numpy())
    np.testing.assert_array_equal(got["coords"], (ref["coords"] * 4).numpy())


# -- Builder and Trainer --------------------------------------------------------

YAML = "tpupose/configs/method/bottom_up_w32.yaml"
TINY = ("model.backbone=resnet18", "model.deconv_channels=[32,32,32]",
        "data.image_size=[64,64]", "model.heatmap_size=[16,16]",
        "model.num_keypoints=4", "train.mixed_precision=false",
        "train.batch_size=16", "train.epochs=1", "train.warmup_epochs=0",
        "train.log_interval=100", "eval.batch_size=16",
        "data.max_instances=6")


def _cfgs(*over):
    from tpupose.configs import load_config as jload
    from tpupose_torch.configs import parse_args, update_config
    from tpupose_torch.configs.default import default_config

    args = parse_args(["--cfg", YAML, "--device", "cpu", *over])
    d = dict(o.split("=", 1) for o in over)
    return update_config(default_config(), args), jload(YAML, d)


def test_builder_on_the_yaml():
    """bottom_up_w32.yaml at full width: HRNet-W32 with a 1x1 conv to 34
    channels; the AE loss bound to the config's sigma and weights."""
    from tpupose_torch.engine.builder import Builder

    cfg, _ = _cfgs()
    b = Builder(cfg, "cpu")
    m = b.model()
    assert isinstance(m, BottomUpPose) and m.backbone_name == "hrnet_w32"
    assert m.final_layer.out_channels == 34
    assert m.final_layer.weight.dtype == torch.float32
    fn = b.loss()
    assert fn.func is pae.ae_loss and fn.keywords == {
        "sigma": 2.0, "tag_sigma": 1.0, "pull_weight": 1e-3,
        "push_weight": 1e-3}


def test_trainer_evaluate_matches_jax(tmp_path):
    """evaluate_bottom_up (and validate) of JAX's Trainer and the port's
    on the same weights: every metric within 1e-4; then one epoch of the
    port (loss parts finite) and evaluate() with eval.int8 finite."""
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.trainer import Trainer as PTrainer

    pc, jc = _cfgs(*TINY, f"train.output_dir={tmp_path}")
    jt, pt = JTrainer(jc), PTrainer(pc, device="cpu")
    assert pt.family == "bottom_up"
    pt.model.load_state_dict(from_flax_bottom_up(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}))
    want, got = jt.evaluate(), pt.evaluate()
    assert sorted(got) == sorted(want) and "mAP" in got
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
    np.testing.assert_allclose(pt.validate(), jt.validate(), rtol=1e-4)
    assert np.isfinite(pt.iter_one_epoch(0))
    pi8, _ = _cfgs(*TINY, f"train.output_dir={tmp_path}", "eval.int8=true")
    pt.cfg = pi8
    assert all(np.isfinite(v) for v in pt.evaluate().values())
