"""SimCC in the port (losses/simcc.py, ops/decode.decode_simcc /
simcc_flip_back, models/simcc.py, utils/convert.from_flax_simcc,
make_simcc_train_step, the evaluator's simcc family, the Builder and the
Trainer) held against the JAX package on the CPU, float32, on numpy
seeded inputs and flax weights carried across by the converter.

Models are small: SimCC on a ResNet-18 and on the width-8 "hrnet_t8"
(tests/test_torch_quant.py) at 64x48, split ratio 2 (bins 96 x 128).
Tolerances, with their reasons:
  - targets and the decode: elementwise float32 (1e-6; sub-bin offsets
    1e-5 bin, a ratio of differences of log-probabilities);
  - the loss: float32 sums of a few hundred terms in another order, rtol
    3e-6; gradients elementwise, 1e-6 of their max;
  - the forward: 1e-4 of the logits' range (float32 sums in another
    order); flip_back: equal;
  - three device-affine train steps: as the R50 steps of
    tests/test_torch_train.py (first loss 1e-4, losses 1e-3, grad norms
    2e-2); the state against the port's own float64 run (see the test);
  - the evaluator on a model whose logits peak at the joints: source
    coordinates within 1e-4 px, metrics within 1e-5; the Trainer's
    evaluate() on a random SimCC-R18 within 1e-4 (test_torch_evaluate's).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.data.loader import BatchLoader as JLoader
from tpupose.data.synthetic import SyntheticTopDownDataset as JSynthetic
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.train_state import TrainState as JState
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_simcc_train_step as j_step
from tpupose.losses.simcc import gaussian_1d_targets as j_targets
from tpupose.losses.simcc import simcc_kl_loss as j_kl
from tpupose.models.simcc import SimCCPose as JSimCC
from tpupose.ops import decode as jdec
from tpupose.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.data.loader import BatchLoader as PLoader
from tpupose_torch.data.synthetic import SyntheticTopDownDataset
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import TrainState, make_simcc_train_step
from tpupose_torch.losses.simcc import gaussian_1d_targets, simcc_kl_loss
from tpupose_torch.models.simcc import SimCCPose
from tpupose_torch.ops import decode as pdec
from tpupose_torch.utils.convert import from_flax_simcc

from test_torch_model import _randomize_bn
from test_torch_quant import one_torch_thread, tiny_spec  # noqa: F401
from test_torch_train import _jax_draws

T = torch.from_numpy
K = 4
HW = (64, 48)
BINS = (128, 96)


# -- targets, loss, decode ------------------------------------------------------

def _joints():
    """Bin-coordinate joints inside, on the 3-sigma border (sigma 6: -18
    and Wb - 1 + 18 are out, a hair inside is in), far out, unlabelled."""
    xs = [3.3, 50.0, -17.99, -18.0, 112.99, 113.0, 400.0, 60.7]
    ys = [5.1, 64.0, 40.0, 9.0, 20.0, 2.0, -30.0, 145.99]
    j = np.stack([xs, ys], -1).astype(np.float32).reshape(2, 4, 2)
    vis = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    return j, vis


def test_gaussian_1d_targets_match_jax():
    j, vis = _joints()
    got = gaussian_1d_targets(T(j), T(vis), BINS, 6.0)
    want = j_targets(jnp.asarray(j), jnp.asarray(vis), BINS, 6.0)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].numpy().tolist() == [[1, 1, 1, 0], [1, 0, 0, 0]]


@pytest.mark.parametrize("weighted", [True, False])
def test_kl_loss_and_gradients_match_jax(weighted):
    rs = np.random.RandomState(1)
    j, vis = _joints()
    tx, ty, tw = (np.array(a) for a in j_targets(jnp.asarray(j),
                                                   jnp.asarray(vis), BINS))
    xl = rs.normal(0, 3, (2, 4, BINS[1])).astype(np.float32)
    yl = rs.normal(0, 3, (2, 4, BINS[0])).astype(np.float32)
    w = tw if weighted else None
    jv, jg = jax.value_and_grad(
        lambda a, b: j_kl((a, b), (tx, ty), w), argnums=(0, 1))(
        jnp.asarray(xl), jnp.asarray(yl))
    a, b = T(xl).requires_grad_(True), T(yl).requires_grad_(True)
    v = simcc_kl_loss((a, b), (T(tx), T(ty)),
                      None if w is None else T(w))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=3e-6)
    for g, want in ((a.grad, jg[0]), (b.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _logits(seed=2):
    """Random logits, a row with its peak on each border, an exact
    two-bin tie (the first wins in both) and a flat row."""
    rs = np.random.RandomState(seed)
    xl = rs.normal(0, 2, (3, K, 40)).astype(np.float32)
    yl = rs.normal(0, 2, (3, K, 50)).astype(np.float32)
    xl[0, 0, 0] = xl[0, 1, -1] = 30.0
    xl[1, 0, 7] = xl[1, 0, 21] = 30.0
    yl[2, 3] = 0.5
    return xl, yl


@pytest.mark.parametrize("refine", [True, False])
def test_decode_simcc_matches_jax(refine):
    xl, yl = _logits()
    gc, gs = pdec.decode_simcc(T(xl), T(yl), refine=refine)
    wc, ws = jdec.decode_simcc(jnp.asarray(xl), jnp.asarray(yl),
                               refine=refine)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    # the tie goes to the first bin, the border peak stays unrefined
    assert int(gc[1, 0, 0]) == 7 and gc[0, 0, 0] == 0.0


@pytest.mark.parametrize("shift", [0, 1, 3])
def test_simcc_flip_back_matches_jax(shift):
    xl, yl = _logits(3)
    pairs = np.array([(0, 1), (2, 3)])
    got = pdec.simcc_flip_back(T(xl), T(yl), pairs, shift_bins=shift)
    want = jdec.simcc_flip_back(jnp.asarray(xl), jnp.asarray(yl), pairs,
                                shift_bins=shift)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nopair = pdec.simcc_flip_back(T(xl), T(yl), np.zeros((0, 2), np.int64),
                                  shift_bins=shift)
    np.testing.assert_array_equal(nopair[1].numpy(), yl)


# -- the model and the converter ------------------------------------------------

def _flax_simcc(backbone, seed=0):
    jm = JSimCC(backbone=backbone, num_keypoints=K, split_ratio=2.0,
                dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    return jm, _randomize_bn(v, np.random.RandomState(seed + 1))


def _port_simcc(backbone, v, dtype=torch.float32, param_dtype=None):
    tm = SimCCPose(backbone, K, 2.0, HW, dtype=dtype, device="cpu",
                   param_dtype=param_dtype)
    tm.load_state_dict(from_flax_simcc(v))
    return tm


@pytest.mark.parametrize("backbone", ["resnet18", "hrnet_t8"])
def test_converter_and_forward_match_jax(backbone):
    """Every port tensor gets a value and every flax leaf is used once;
    every conv and dense layer has its flax path; the logits equal
    flax's (the flatten in row-major (h, w) order, the dense kernels
    transposed)."""
    jm, v = _flax_simcc(backbone, seed=3)
    tm = _port_simcc(backbone, v)
    paths = {}
    sd = from_flax_simcc(v, paths)
    assert set(sd) == set(tm.state_dict())
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(v))
    assert n_flax == sum(t.numel() for k, t in sd.items()
                         if not k.endswith("num_batches_tracked"))
    layers = {n for n, m in tm.named_modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    assert set(paths) == layers
    assert paths["head.mlp_x"] == "SimCCHead_0/mlp_x"
    x = np.random.RandomState(4).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    want = jax.jit(lambda a: jm.apply(v, a, train=False))(x)
    got = tm(T(x))
    for g, w, n in zip(got, want, (BINS[1], BINS[0])):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, K, n)
        assert np.abs(g.detach().numpy() - w).max() / np.abs(w).max() < 1e-4


def test_bin_projections_run_in_float32_under_autocast():
    tm = SimCCPose("resnet18", K, 2.0, HW, dtype=torch.bfloat16,
                   device="cpu", param_dtype=torch.float32)
    seen = {}
    for name in ("kpt_conv", "mlp_x"):
        getattr(tm.head, name).register_forward_hook(
            lambda m, a, o, n=name: seen.update({n: (a[0].dtype, o.dtype)}))
    xl, yl = tm(torch.zeros(1, *HW, 3))
    assert seen == {"kpt_conv": (torch.bfloat16, torch.bfloat16),
                    "mlp_x": (torch.float32, torch.float32)}
    assert xl.dtype == yl.dtype == torch.float32
    with pytest.raises(ValueError, match="built for"):
        tm(torch.zeros(1, 64, 64, 3))


# -- three device-affine train steps against JAX --------------------------------

B = 4
AUG = dict(color_jitter_strength=0.2, jitter_seed=3, affine_rotation=30.0,
           affine_scale=0.25)


def _batch():
    """Joints of the synthetic set on the bin grid, noise pixels (see
    tests/test_torch_train.py's _batch: black crops leave the BatchNorms
    ill-conditioned in float32)."""
    ds = JSynthetic(B, HW, BINS, K, seed=0)
    s = [ds[i] for i in range(B)]
    rs = np.random.RandomState(5)
    return {"images": rs.randint(0, 256, (B, *HW, 3)).astype(np.uint8),
            "joints": np.stack([x["joints"] for x in s]),
            "visibility": np.stack([x["visibility"] for x in s])}


@pytest.fixture(scope="module")
def sgd_run():
    """3 steps of tpupose's jitted SimCC step and of the port's, SGD
    (momentum 0.9, clip 10, lr 0.01 backbone / 0.02 head), the port's
    draws taken from the JAX keys."""
    jm, v = _flax_simcc("resnet18")
    kw = dict(name="sgd", lr=0.01, head_lr=0.02, momentum=0.9)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0)
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               jnp.zeros((1, *HW, 3)), tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))
    init_sd = from_flax_simcc(v)
    tstates = {}
    for dt in (torch.float32, torch.float64):
        model = _port_simcc("resnet18", v, dtype=dt)
        opt = make_optimizer(OptimizerConfig(**kw), model.named_parameters(),
                             is_head=lambda n: not is_backbone_path(n),
                             grad_clip_norm=10.0)
        tstates[dt] = TrainState(model, opt)
    batch = _batch()
    jstep = j_step(j_kl, BINS, sigma=6.0, **AUG)
    tstep = make_simcc_train_step(simcc_kl_loss, BINS, sigma=6.0, **AUG)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    out = []
    for t in range(3):
        state, jmet = jstep(state, jb)
        aff, jit = _jax_draws(AUG["jitter_seed"], t, B, 30.0, 0.25, 0.2)
        tmet = {dt: tstep(ts, tb, draws={"affine": aff, "jitter": jit})
                for dt, ts in tstates.items()}[torch.float32]
        out.append(((float(jmet["loss"]), float(jmet["grad_norm"])),
                    (tmet["loss"].item(), tmet["grad_norm"].item())))
    want = from_flax_simcc({"params": jax.device_get(state.params),
                            "batch_stats": jax.device_get(state.batch_stats)})
    return (out, init_sd, want, tstates[torch.float32].model.state_dict(),
            tstates[torch.float64].model.state_dict())


def test_train_steps_match_jax(sgd_run):
    """The first loss rtol 1e-4, every loss rtol 1e-3, every grad_norm
    rtol 2e-2 (the R50 steps' bounds). The state after 3 steps: the
    port's float32 run within 1e-4 of each tensor's max of its float64
    run, JAX's float32 within 1e-2 of the float64 run: flax's train-mode
    BatchNorm backward cancels in float32 (ROADMAP Queue C, pinned for
    the R50 in tests/test_torch_train.py), most in layer1, which the KL
    gradient reaches through the bin projections. Printed with -s."""
    steps, init, want_sd, got32, got64 = sgd_run
    for t, ((jl, jg), (tl, tg)) in enumerate(steps):
        print(f"simcc step {t}: loss rel {abs(tl / jl - 1):.3g}, "
              f"grad_norm rel {abs(tg / jg - 1):.3g}")
    np.testing.assert_allclose(steps[0][1][0], steps[0][0][0], rtol=1e-4)
    for (jl, jg), (tl, tg) in steps:
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        np.testing.assert_allclose(tg, jg, rtol=2e-2)
    worst = {"port": 0.0, "jax": 0.0}
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = got64[k].double().numpy()
        scale = np.abs(ref).max()
        for name, t in (("port", got32[k].numpy()), ("jax", w.numpy())):
            worst[name] = max(worst[name], np.abs(t - ref).max() / scale)
        assert not np.array_equal(w.numpy(), init[k].numpy()), k
    print(f"state after 3 steps vs the port in float64: {worst}")
    assert worst["port"] <= 1e-4 and worst["jax"] <= 1e-2, worst


def test_step_draws_depend_on_seed_and_step_only():
    step = make_simcc_train_step(simcc_kl_loss, BINS, **AUG)
    a, b = step.draws_for(7, 4, "cpu"), step.draws_for(7, 4, "cpu")
    for x, y in zip(a["affine"] + a["jitter"], b["affine"] + b["jitter"]):
        assert torch.equal(x, y)
    assert not torch.equal(a["affine"][0],
                           step.draws_for(8, 4, "cpu")["affine"][0])


# -- the evaluator on a model whose logits peak at the joints -------------------

# the image channel each keypoint's logits read: keypoints 1 and 2 (a
# left/right pair) read one channel, so a mirrored crop's keypoint 2 is
# the crop's keypoint 1 mirrored, as the flip test assumes
CHANNEL = (0, 1, 1, 0)


class JPeak(nn.Module):
    """Logits that peak at each crop's painted joints: per keypoint the
    column and row means of its channel of the un-normalized image,
    repeated onto the bins (ratio 2) and scaled."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        gain = self.param("gain", nn.initializers.ones, ())
        x = x.astype(jnp.float32) * jnp.asarray(IMAGENET_STD) \
            + jnp.asarray(IMAGENET_MEAN)
        ch = jnp.stack([x[..., c] for c in CHANNEL], 1)        # (B,K,H,W)
        cols = jnp.repeat(ch.mean(2), 2, -1) * 40.0 * gain
        rows = jnp.repeat(ch.mean(3), 2, -1) * 40.0 * gain
        return cols, rows


class PPeak(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        x = x.float() * torch.tensor(IMAGENET_STD) + torch.tensor(
            IMAGENET_MEAN)
        ch = torch.stack([x[..., c] for c in CHANNEL], 1)
        cols = ch.mean(2).repeat_interleave(2, -1) * 40.0 * self.gain
        rows = ch.mean(3).repeat_interleave(2, -1) * 40.0 * self.gain
        return cols, rows


def _painted(n=10, seed=6):
    """uint8 crops with a bright cross in channels 0 and 1 at the joints
    (bin coordinates / 2; keypoints reading one channel share a joint),
    joints on the bin grid, centres and scales."""
    rs = np.random.RandomState(seed)
    imgs = np.zeros((n, *HW, 3), np.uint8)
    joints = np.zeros((n, K, 2), np.float32)
    for i in range(n):
        for c in range(2):
            x, y = rs.randint(4, HW[1] - 4), rs.randint(4, HW[0] - 4)
            imgs[i, :, x, c] = 200 + c
            imgs[i, y, :, c] = 150 + c
            joints[i, [k for k in range(K) if CHANNEL[k] == c]] = (2 * x,
                                                                  2 * y)
    centers = rs.uniform(100, 200, (n, 2)).astype(np.float32)
    scales = np.tile(np.float32([[90.0, 120.0]]), (n, 1)) \
        * rs.uniform(0.8, 1.2, (n, 1)).astype(np.float32)
    return imgs, joints, centers, scales


def _jstate(apply_fn, v):
    return JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                  batch_stats={}, opt_state=(), apply_fn=apply_fn,
                  tx=optax.sgd(0.0))


class _Loader(list):
    """Batches of the painted crops with GT in source coords."""


def _loader(udp):
    from tpupose.ops.affine import transform_preds

    imgs, joints, centers, scales = _painted()
    out = _Loader()
    for i in range(0, len(imgs), 4):
        sl = slice(i, i + 4)
        src = np.asarray(jax.vmap(lambda c, ct, sc: transform_preds(
            c, ct, sc, BINS, udp=udp))(joints[sl], centers[sl], scales[sl]))
        out.append({"images": imgs[sl], "center": centers[sl],
                    "scale": scales[sl], "joints_src": src,
                    "visibility": np.ones((len(src), K), np.float32)})
    return out


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
@pytest.mark.parametrize("udp", [False, True], ids=["classic", "udp"])
def test_evaluator_matches_jax(flip, udp):
    """The simcc family's flip merge (bin reversal shifted by round(r) -
    1 = 1 bin, 0 under udp; probabilities averaged), decode and
    back-projection: source coordinates within 1e-4 px, PCK, MPJPE and
    OKS-AP within 1e-5 of JAX's (the coordinates, ~150 px, carry
    float32's 1.5e-5 px resolution); the peaks are found (MPJPE below a
    source px)."""
    from tpupose.metrics import MPJPE as JMPJPE, OKSAP as JOKSAP, PCK as JPCK
    from tpupose_torch.metrics import MPJPE, OKSAP, PCK

    v = JPeak().init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    pairs = np.array([(1, 2)])
    jev = JEvaluator(_jstate(JPeak().apply, v), BINS, flip_test=flip,
                     flip_pairs=pairs, family="simcc", udp=udp)
    pev = TopDownEvaluator(PPeak(), BINS, flip_test=flip, flip_pairs=pairs,
                           family="simcc", udp=udp, device="cpu")
    loader = _loader(udp)
    for b in loader:
        wc, ws = jev.step(b["images"], b["center"], b["scale"])
        gc, gs = pev.step(b["images"], b["center"], b["scale"])
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5)
    sig = np.full(K, 0.08, np.float32)
    want = jev.run(loader, [JPCK(alpha=0.2), JMPJPE(),
                            JOKSAP(num_classes=1, sigmas=sig)])
    got = pev.run(loader, [PCK(alpha=0.2), MPJPE(),
                           OKSAP(num_classes=1, sigmas=sig)])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * max(1.0, abs(w)), (k, got[k], w)
    assert got["mpjpe"] < 1.0 and got["pck"] >= 0.9, got


def test_evaluator_refuses_an_int8_engine_for_simcc():
    with pytest.raises(ValueError, match="heatmap family"):
        TopDownEvaluator(PPeak(), BINS, family="simcc", device="cpu",
                         int8_engine=object())
    with pytest.raises(ValueError, match="family"):
        TopDownEvaluator(PPeak(), BINS, family="yolo", device="cpu")


# -- Builder and Trainer --------------------------------------------------------

YAML = "tpupose/configs/method/simcc_r50.yaml"
TINY = ("model.backbone=resnet18", "data.image_size=[64,48]",
        "model.heatmap_size=[128,96]", "model.num_keypoints=4",
        "train.mixed_precision=false", "train.batch_size=16",
        "train.epochs=2", "train.warmup_epochs=0", "train.log_interval=100",
        "eval.batch_size=16", "data.device_affine=true",
        "eval.metrics=['pck','mpjpe','oks_ap']")


def _cfgs(*over):
    from tpupose.configs import load_config as jload
    from tpupose_torch.configs import parse_args, update_config
    from tpupose_torch.configs.default import default_config

    args = parse_args(["--cfg", YAML, "--device", "cpu", *over])
    d = dict(o.split("=", 1) for o in over)
    return update_config(default_config(), args), jload(YAML, d)


def test_builder_on_the_yaml():
    """simcc_r50.yaml at full width: SimCC-R50 with (8 x 6) -> 384 / 512
    bin projections, the simcc_kl loss; a heatmap_size off the bin grid
    raises."""
    from tpupose_torch.engine.builder import Builder

    cfg, _ = _cfgs()
    b = Builder(cfg, "cpu")
    m = b.model()
    assert isinstance(m, SimCCPose) and m.backbone_name == "resnet50"
    assert (m.head.mlp_x.in_features, m.head.mlp_x.out_features,
            m.head.mlp_y.out_features) == (48, 384, 512)
    assert m.head.mlp_x.weight.dtype == torch.float32
    assert m.compute_dtype == torch.bfloat16
    assert b.loss() is simcc_kl_loss
    bad, _ = _cfgs("model.heatmap_size=[64,48]")
    with pytest.raises(ValueError, match="split_ratio"):
        Builder(bad, "cpu").model()


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.trainer import Trainer as PTrainer

    tmp = tmp_path_factory.mktemp("simcc")
    pc, jc = _cfgs(*TINY, f"train.output_dir={tmp}")
    jt, pt = JTrainer(jc), PTrainer(pc, device="cpu")
    pt.model.load_state_dict(from_flax_simcc(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}))
    return jt, pt


def test_trainer_evaluate_and_validate_match_jax(trainers):
    jt, pt = trainers
    assert pt.family == "simcc"
    want, got = jt.evaluate(), pt.evaluate()
    assert {"pck", "mpjpe", "mAP"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
    np.testing.assert_allclose(pt.validate(), jt.validate(), rtol=1e-4)


def test_trainer_trains(tmp_path):
    """Two epochs of the port's Trainer on 64 synthetic crops (device
    affine on): finite, falling losses, finite metrics."""
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset as PS
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.trainer import Trainer

    class Small(Builder):
        def dataset(self, split="train"):
            return PS(64 if split == "train" else 16, HW, BINS, K,
                      seed=0 if split == "train" else 1)

    cfg, _ = _cfgs(*TINY, f"train.output_dir={tmp_path}",
                   "optimizer.lr=2e-3")
    pt = Trainer(cfg, builder=Small(cfg, "cpu"), device="cpu")
    losses = [pt.iter_one_epoch(e) for e in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
    assert all(np.isfinite(v) for v in pt.evaluate().values())


def test_synthetic_bins_are_the_jax_ones():
    a = SyntheticTopDownDataset(2, HW, BINS, K, seed=1)
    b = JSynthetic(2, HW, BINS, K, seed=1)
    for i in range(2):
        for k, v in b[i].items():
            np.testing.assert_array_equal(a[i][k], v)
    pl, jl = PLoader(a, batch_size=2), JLoader(b, batch_size=2)
    assert len(list(pl)) == len(list(jl)) == 1
