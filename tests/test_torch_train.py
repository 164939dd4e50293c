"""The training slice of tpupose_torch (SimpleBaseline heatmap family)
held against the JAX package on the CPU, on seeded numpy inputs, JAX at
float32 (flax models built with dtype=float32):

  - Gaussian targets and the JointsMSE losses (values and gradients);
  - color jitter and the affine augmentation, with the draws the JAX
    code makes from its keys handed to the port (threefry bits cannot
    be reproduced by a torch.Generator);
  - every lr schedule, the optimizers with the head/base/frozen groups
    and global-norm clipping, BatchNorm's train-mode statistics;
  - three train steps against `make_heatmap_train_step` with
    augmentation on (SGD + EMA, and Adam);
  - the Trainer on the CPU: loss falls, validate, checkpoint round trip,
    the best slot, the CLI.

Each tolerance is stated where it is used, with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.configs.default import SchedulerConfig as JSchedulerConfig
from tpupose.data.synthetic import SyntheticTopDownDataset as JSynthetic
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.schedulers import SCHEDULERS as J_SCHEDULERS
from tpupose.engine.schedulers import make_schedule as j_make_schedule
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_heatmap_train_step as j_train_step
from tpupose.losses.heatmap import joints_mse_loss as j_mse
from tpupose.losses.heatmap import joints_mse_weighted_loss as j_mse_w
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose.ops.affine import batched_affine_warp as j_warp
from tpupose.ops.affine import random_affine_augment as j_augment
from tpupose.ops.heatmap import gaussian_heatmaps as j_gauss
from tpupose.ops.heatmap import heatmap_target_weights as j_weights
from tpupose.ops.preprocess import color_jitter as j_jitter
from tpupose_torch.configs.default import (OptimizerConfig, SchedulerConfig,
                                           default_config)
from tpupose_torch.data.synthetic import SyntheticTopDownDataset
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import UNPORTED, make_optimizer
from tpupose_torch.engine.schedulers import SCHEDULERS, make_schedule
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_train_step)
from tpupose_torch.losses.heatmap import (joints_mse_loss,
                                          joints_mse_weighted_loss)
from tpupose_torch.models.backbones.resnet import BatchNorm2d
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.ops.affine import (augment_matrices, batched_affine_warp,
                                      random_affine_augment)
from tpupose_torch.ops.heatmap import gaussian_heatmaps, heatmap_target_weights
from tpupose_torch.ops.preprocess import color_jitter
from tpupose_torch.utils.convert import conv_weight, from_flax_simple_baseline

from test_torch_model import _randomize_bn
from torch_threads import all_torch_threads, one_torch_thread  # noqa: F401

T = torch.from_numpy


# -- targets and losses -------------------------------------------------------

def _joints():
    """Joints inside the 16x16 map, on the 3-sigma border (sigma 2: the
    box reaches r = 7 px, so x = -7 and x = 22.99 still overlap the map,
    x = -7.01 and x = 23 do not), far outside, and one unlabeled."""
    xs = [3.3, 8.0, -7.0, -7.01, 22.99, 23.0, 40.0, 12.7]
    ys = [5.1, 8.0, 4.0, 9.0, 8.0, 2.0, -30.0, 15.2]
    j = np.stack([xs, ys], -1).astype(np.float32).reshape(2, 4, 2)
    vis = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    return j, vis


@pytest.mark.parametrize("unbiased", [True, False])
def test_gaussian_targets_and_weights(unbiased):
    """Elementwise exp of the same float32 distances: equal to 1e-6."""
    j, vis = _joints()
    g, w = gaussian_heatmaps(T(j), T(vis), (16, 16), 2.0, unbiased=unbiased)
    jg, jw = j_gauss(jnp.asarray(j), jnp.asarray(vis), (16, 16), 2.0,
                     unbiased=unbiased)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        heatmap_target_weights(T(j), T(vis), (16, 16), 2.0).numpy(),
        np.asarray(j_weights(jnp.asarray(j), jnp.asarray(vis), (16, 16),
                             2.0)))
    assert w.numpy().tolist() == [[1, 1, 1, 0], [1, 0, 0, 0]]


def _loss_case(layout, seed=3):
    rs = np.random.RandomState(seed)
    j, vis = _joints()
    tgt, tw = j_gauss(jnp.asarray(j), jnp.asarray(vis), (16, 16), 2.0)
    tgt, tw = np.array(tgt), np.array(tw)
    pred = rs.uniform(-0.2, 1.0, tgt.shape).astype(np.float32)
    if layout == "NHWK":
        tgt, pred = tgt.transpose(0, 2, 3, 1), pred.transpose(0, 2, 3, 1)
    return np.ascontiguousarray(pred), np.ascontiguousarray(tgt), tw


@pytest.mark.parametrize("layout", ["NHWK", "NKHW"])
@pytest.mark.parametrize("kind", ["weighted", "unweighted", "no_target_weight",
                                  "heatmap_weighted", "heatmap_weighted_tw"])
def test_losses_and_gradients(layout, kind):
    """Value and d loss / d pred, jax.grad against autograd. The
    gradients are elementwise float32 arithmetic: rtol 1e-6. The values
    are float32 sums of 2048 terms taken in two different orders, each
    within ~sqrt(2048) * 2^-24 = 2.7e-6 of the exact sum: rtol 3e-6."""
    pred, tgt, tw = _loss_case(layout)
    if kind == "weighted":
        jf = lambda p: j_mse(p, tgt, tw)
        tf = lambda p: joints_mse_loss(p, T(tgt), T(tw))
    elif kind == "unweighted":
        jf = lambda p: j_mse(p, tgt, None)
        tf = lambda p: joints_mse_loss(p, T(tgt), None)
    elif kind == "no_target_weight":
        jf = lambda p: j_mse(p, tgt, tw, use_target_weight=False)
        tf = lambda p: joints_mse_loss(p, T(tgt), T(tw),
                                       use_target_weight=False)
    elif kind == "heatmap_weighted":
        jf = lambda p: j_mse_w(p, tgt, None)
        tf = lambda p: joints_mse_weighted_loss(p, T(tgt), None)
    else:
        jf = lambda p: j_mse_w(p, tgt, tw)
        tf = lambda p: joints_mse_weighted_loss(p, T(tgt), T(tw))
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = T(pred).requires_grad_(True)
    v = tf(p)
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=3e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())


# -- augmentation -------------------------------------------------------------

def _jax_draws(seed, step, B, rotation, scale, strength):
    """The draws of tpupose's heatmap train step for update `step`, made
    from its keys exactly as ops/affine.py:174-179 and
    ops/preprocess.py:39-43 make them."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    rng_aff, rng_jit = jax.random.split(rng)
    return _affine_draws(rng_aff, B, rotation, scale), \
        _jitter_draws(rng_jit, B, strength)


def _affine_draws(rng, B, rf, sf, rot_prob=0.6):
    r_s, r_r, r_p = jax.random.split(rng, 3)
    mult = jnp.clip(1.0 + jax.random.normal(r_s, (B,)) * sf, 1.0 - sf,
                    1.0 + sf)
    rot = jnp.clip(jax.random.normal(r_r, (B,)) * rf, -2.0 * rf, 2.0 * rf)
    rot = jnp.where(jax.random.uniform(r_p, (B,)) < rot_prob, rot, 0.0)
    return T(np.asarray(mult)), T(np.asarray(rot))


def _jitter_draws(rng, B, strength):
    b, c, s = jax.random.split(rng, 3)
    return tuple(T(np.asarray(1.0 + jax.random.uniform(
        k, (B, 1, 1, 1), minval=-strength, maxval=strength)).reshape(B))
        for k in (b, c, s))


def test_color_jitter_with_jax_draws():
    """Same draws, same float32 operations (two means in another
    summation order): atol 1e-6 on [0, 1] values."""
    rs = np.random.RandomState(4)
    x = rs.uniform(0, 1, (3, 16, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_jitter(jnp.asarray(x), key, 0.2))
    got = color_jitter(T(x), _jitter_draws(key, 3, 0.2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("udp", [False, True])
def test_random_affine_augment_with_jax_draws(udp):
    """Images atol 1e-2 on 0-255 values (the warp; see
    tests/test_torch_warp.py), joints atol 1e-4 heatmap px (2x2 products
    summed in another order), visibility equal."""
    rs = np.random.RandomState(6)
    B, H, W, Hh, Wh = 6, 64, 48, 16, 12
    imgs = rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    joints = np.stack([rs.uniform(-1, Wh + 1, (B, 5)),
                       rs.uniform(-1, Hh + 1, (B, 5))], -1).astype(np.float32)
    vis = (rs.uniform(size=(B, 5)) > 0.2).astype(np.float32)
    key = jax.random.PRNGKey(7)
    wi, wj, wv = j_augment(jnp.asarray(imgs), jnp.asarray(joints),
                           jnp.asarray(vis), key, 30.0, 0.25, (Hh, Wh),
                           udp=udp)
    mult, rot = _affine_draws(key, B, 30.0, 0.25)
    gi, gj, gv = random_affine_augment(T(imgs), T(joints), T(vis), mult, rot,
                                       (Hh, Wh), udp=udp)
    assert gi.dtype == torch.float32
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=1e-2)
    np.testing.assert_allclose(gj.numpy(), np.asarray(wj), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < gv.sum() < vis.sum()            # some joints left the map


def test_step_draws_depend_on_seed_and_step_only():
    """A resumed run draws the same values: the draws of update t come
    from a generator seeded from (seed, t) alone."""
    step = make_heatmap_train_step(j_mse, color_jitter_strength=0.2,
                                   jitter_seed=3, heatmap_size=(16, 16),
                                   affine_rotation=30.0, affine_scale=0.25)
    a, b = step.draws_for(7, 4, "cpu"), step.draws_for(7, 4, "cpu")
    c = step.draws_for(8, 4, "cpu")
    for x, y in zip(a["affine"] + a["jitter"], b["affine"] + b["jitter"]):
        assert torch.equal(x, y)
    assert not torch.equal(a["affine"][0], c["affine"][0])


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", sorted(J_SCHEDULERS))
def test_schedule_matches_optax(name, warmup):
    """lr(t) at every update of a 40-step run, rtol 1e-6. optax computes
    in float32 and the port in float64, so an atol of float32's
    resolution at the base lr (2^-24 * 1e-3) is added: near the end of a
    cosine the lr is a small difference of numbers of order base_lr."""
    assert set(SCHEDULERS) == set(J_SCHEDULERS)
    kw = dict(name=name, min_lr=1e-6, step_size=3, gamma=0.5,
              milestones=(2, 5))
    jcfg, cfg = JSchedulerConfig(**kw), SchedulerConfig(**kw)
    for base in (1e-3, 1e-2):
        want = j_make_schedule(jcfg, base, 40, warmup, 4)
        got = make_schedule(cfg, base, 40, warmup, 4)
        w = np.array([float(want(t)) for t in range(40)])
        g = np.array([got(t) for t in range(40)])
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=2.0 ** -24 * base)
        if warmup:
            assert g[0] == 0.0            # the first update has lr 0


# -- optimizers ---------------------------------------------------------------

def _param_tree(seed=8):
    rs = np.random.RandomState(seed)
    shapes = {"backbone": {"w": (5, 3), "b": (3,)},
              "head": {"w": (3, 4), "b": (4,)}}
    return {g: {k: rs.normal(0, 1, s).astype(np.float32)
                for k, s in d.items()} for g, d in shapes.items()}


OPT_CASES = [("sgd", False), ("nesterov", False), ("adam", False),
             ("adamw", False), ("adam", True), ("adamax", False),
             ("nadam", False), ("radam", False), ("rmsprop", False),
             ("adagrad", False), ("adadelta", False)]


@pytest.mark.parametrize("name,frozen", OPT_CASES,
                         ids=[f"{n}{'_frozen' if f else ''}"
                              for n, f in OPT_CASES])
def test_optimizer_matches_optax(name, frozen):
    """Same gradients into the port's make_optimizer and tpupose's for 5
    updates; gradient norms ~30-90 against clip 10 (clipping triggers),
    head/base split with separate warmup+cosine schedules, optionally a
    frozen backbone (set_to_zero, but its gradients still count in the
    clip norm). Params rtol 1e-5 (float32 update arithmetic in another
    order)."""
    tree = _param_tree()
    kw = dict(name=name, lr=1e-2, head_lr=5e-2, weight_decay=1e-2)
    cfg, jcfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    scfg = dict(name="cosine", min_lr=1e-4)
    jb = j_make_schedule(JSchedulerConfig(**scfg), cfg.lr, 8, 2, 1)
    jh = j_make_schedule(JSchedulerConfig(**scfg), cfg.head_lr, 8, 2, 1)
    tb = make_schedule(SchedulerConfig(**scfg), cfg.lr, 8, 2, 1)
    th = make_schedule(SchedulerConfig(**scfg), cfg.head_lr, 8, 2, 1)
    tx = j_make_optimizer(jcfg, schedule=jb, head_schedule=jh, params=tree,
                          is_head=lambda p: not j_is_backbone(p),
                          is_frozen=j_is_backbone if frozen else None,
                          grad_clip_norm=10.0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    tparams = {f"{g}.{k}": torch.nn.Parameter(T(v.copy()))
               for g, d in tree.items() for k, v in d.items()}
    opt = make_optimizer(cfg, list(tparams.items()), schedule=tb,
                         head_schedule=th,
                         is_head=lambda n: not is_backbone_path(n),
                         is_frozen=is_backbone_path if frozen else None,
                         grad_clip_norm=10.0)
    rs = np.random.RandomState(9)
    for _ in range(5):
        grads = {g: {k: rs.normal(0, 20, v.shape).astype(np.float32)
                     for k, v in d.items()} for g, d in tree.items()}
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   opt_state, params)
        params = optax.apply_updates(params, upd)
        want_norm = float(optax.global_norm(grads))
        for n, p in tparams.items():
            g, k = n.split(".")
            p.grad = T(grads[g][k].copy())
        norm = opt.step()
        assert want_norm > 10.0
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
    for n, p in tparams.items():
        g, k = n.split(".")
        want = np.asarray(params[g][k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-7)
        if frozen and g == "backbone":
            np.testing.assert_array_equal(p.detach().numpy(), tree[g][k])


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_optimizers_raise(name):
    with pytest.raises(ValueError, match="ROADMAP"):
        make_optimizer(OptimizerConfig(name=name), [])


def test_grad_accumulation_raises():
    with pytest.raises(ValueError, match="ROADMAP"):
        make_optimizer(OptimizerConfig(name="adam"), [], grad_accum_steps=2)


# -- BatchNorm ----------------------------------------------------------------

def test_batchnorm_running_statistics_match_flax():
    """conv 3x3/2 + BN in train mode, n = 4*2*2 = 16 values per channel.
    The running mean and variance after one update equal flax's
    batch_stats at rtol 1e-5; torch's own nn.BatchNorm2d, which updates
    with the unbiased variance (x 16/15), misses by ~6.7% * 0.1."""
    import flax.linen as fnn

    class ConvBN(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(8, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                         use_bias=False)(x)
            return fnn.BatchNorm(use_running_average=False, momentum=0.9,
                                 epsilon=1e-5)(x)

    rs = np.random.RandomState(10)
    x = rs.normal(0.5, 1.0, (4, 4, 4, 3)).astype(np.float32)
    jm = ConvBN()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    mean0 = rs.normal(0, 0.3, 8).astype(np.float32)
    var0 = rs.uniform(0.5, 2.0, 8).astype(np.float32)
    v["batch_stats"]["BatchNorm_0"] = {"mean": mean0, "var": var0}
    y, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    want = mut["batch_stats"]["BatchNorm_0"]

    conv = torch.nn.Conv2d(3, 8, 3, 2, 1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(conv_weight(v["params"]["Conv_0"]["kernel"]))
    xt = T(x).permute(0, 3, 1, 2)
    results = {}
    for cls in (BatchNorm2d, torch.nn.BatchNorm2d):
        bn = cls(8, eps=1e-5, momentum=0.1).train()
        bn.running_mean.copy_(T(mean0))
        bn.running_var.copy_(T(var0))
        out = bn(conv(xt))
        results[cls] = (bn, out)
    bn, out = results[BatchNorm2d]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want["var"]), rtol=1e-5)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=1e-4, atol=1e-5)
    plain = results[torch.nn.BatchNorm2d][0]
    miss = np.abs(plain.running_var.numpy() - np.asarray(want["var"])) \
        / np.asarray(want["var"])
    assert miss.max() > 1e-3


# -- three train steps against JAX --------------------------------------------

B, HW, HM, K = 4, (64, 64), (16, 16), 4
AUG = dict(color_jitter_strength=0.2, jitter_seed=3, heatmap_size=HM,
           sigma=2.0, affine_rotation=30.0, affine_scale=0.25)


def _batch():
    """Joints and visibility of the synthetic set with uniform-noise
    pixels. The synthetic images are black but for a few blobs, so most
    BatchNorm channels see near-constant inputs and the gradient is
    ill-conditioned: there a float32 gradient differs from a float64 one
    by ~4e-2 relative in either framework, and no 1e-4 comparison can
    hold. Noise pixels keep every channel's spread up."""
    ds = JSynthetic(B, HW, HM, K, seed=0)
    s = [ds[i] for i in range(B)]
    rs = np.random.RandomState(5)
    return {"images": rs.randint(0, 256, (B, *HW, 3)).astype(np.uint8),
            "joints": np.stack([x["joints"] for x in s]),
            "visibility": np.stack([x["visibility"] for x in s])}


def _run_steps(opt_name, lrs, ema_decay, n_steps=3):
    """n_steps of tpupose's jitted heatmap train step and of the port's,
    both float32, from the same flax init with non-trivial BN
    statistics, the port's draws taken from the JAX keys. Returns the
    per-step (loss, grad_norm) pairs, the initial state dict, JAX's final
    params and BN statistics and EMA as the port's state dicts, and the
    port's TrainState."""
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    sample = jnp.zeros((1, *HW, 3), jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), sample, train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(1))
    kw = dict(name=opt_name, lr=lrs[0], head_lr=lrs[1], momentum=0.9)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0)
    state = create_train_state(jm, jax.random.PRNGKey(0), sample, tx,
                               ema_decay=ema_decay)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(
        params=params, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, v["batch_stats"]), opt_state=tx.init(params),
        ema_params=(jax.tree_util.tree_map(jnp.array, params)
                    if ema_decay > 0 else None))

    init_sd = from_flax_simple_baseline(v)
    model = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=torch.float32,
                           device="cpu", param_dtype=torch.float32)
    model.load_state_dict(init_sd)
    opt = make_optimizer(OptimizerConfig(**kw), model.named_parameters(),
                         is_head=lambda n: not is_backbone_path(n),
                         grad_clip_norm=10.0)
    tstate = TrainState(model, opt, ema_decay=ema_decay)

    batch = _batch()
    jstep = j_train_step(lambda p, t, w: j_mse(p, t, w), **AUG)
    tstep = make_heatmap_train_step(lambda p, t, w: joints_mse_loss(p, t, w),
                                    **AUG)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    out = []
    for t in range(n_steps):
        state, jmet = jstep(state, jb)
        aff, jit = _jax_draws(AUG["jitter_seed"], t, B, 30.0, 0.25, 0.2)
        tmet = tstep(tstate, tb, draws={"affine": aff, "jitter": jit})
        out.append(((float(jmet["loss"]), float(jmet["grad_norm"])),
                    (tmet["loss"].item(), tmet["grad_norm"].item())))
    jvars = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    jema = (None if state.ema_params is None else from_flax_simple_baseline(
        {"params": jax.device_get(state.ema_params),
         "batch_stats": jvars["batch_stats"]}))
    return out, init_sd, from_flax_simple_baseline(jvars), jema, tstate


@pytest.fixture(scope="module")
def sgd_run():
    return _run_steps("sgd", (0.01, 0.02), ema_decay=0.99)


@pytest.fixture(scope="module")
def adam_run():
    return _run_steps("adam", (1e-3, 1e-2), ema_decay=0.0)


# Why the whole-step tolerances below are wider than the components'.
# Each piece of the step is held tightly in this file (targets, losses,
# jitter, warp, schedules, optimizers, BatchNorm statistics at 1e-5 or
# better). Composed, three effects set the floor, each pinned by a test
# below that prints its size with -s:
#   1. XLA's jitted warp contracts the source-coordinate products into
#      FMAs, so the warp inside tpupose's jitted step differs from the
#      eager oracle, which the port equals in every element; the bf16
#      cast after the normalize turns some of those differences into
#      one-ulp input changes;
#   2. flax's train-mode BatchNorm computes the variance as
#      E[x^2] - E[x]^2, and in float32 its backward pass cancels where a
#      channel's mean is large against its spread, so JAX's float32
#      gradients here are far less accurate than the port's;
#   3. train-mode BatchNorm over n = 16 values per channel (layer4 at
#      B=4, 64x64) amplifies both.
# The whole-step tests print the differences they meet. The inputs are
# noise pixels (see _batch).


def _report(steps, label):
    for t, ((jl, jg), (tl, tg)) in enumerate(steps):
        print(f"{label} step {t}: loss rel {abs(tl / jl - 1):.3g}, "
              f"grad_norm rel {abs(tg / jg - 1):.3g}")


def test_train_step_sgd_matches_jax(sgd_run):
    """SGD (momentum 0.9, clip 10, lr 0.01 backbone / 0.02 head), 3
    augmented steps: the first loss rtol 1e-4, every loss rtol 1e-3,
    every grad_norm rtol 2e-2; params and running statistics after 3
    steps within 5e-3 * max|tensor| (the update is linear in the
    gradient)."""
    steps, init, want_sd, _, tstate = sgd_run
    _report(steps, "sgd")
    np.testing.assert_allclose(steps[0][1][0], steps[0][0][0], rtol=1e-4)
    for (jl, jg), (tl, tg) in steps:
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        np.testing.assert_allclose(tg, jg, rtol=2e-2)
    assert steps[-1][0][0] < steps[0][0][0]
    got = tstate.model.state_dict()
    moved, worst = 0, 0.0
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].numpy(), w.numpy()
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= 5e-3, k
        worst = max(worst, rel)
        moved += not np.array_equal(w, init[k].numpy())
    print(f"sgd params and statistics after 3 steps: max diff {worst:.3g} "
          f"of max|tensor|")
    assert moved == len([k for k in want_sd
                         if not k.endswith("num_batches_tracked")])


def test_train_step_ema_matches_jax(sgd_run):
    """EMA (decay 0.99, warmed as min(d, (1+t)/(10+t))) of the params
    against JAX's ema_params: within 5e-3 * max|tensor|, the bound of the
    params it averages."""
    _, _, _, jema, tstate = sgd_run
    names = [n for n, _ in tstate.model.named_parameters()]
    assert len(names) == len(tstate.ema)
    for n, e in zip(names, tstate.ema):
        w = jema[n].numpy()
        assert np.abs(e.numpy() - w).max() <= 5e-3 * np.abs(w).max(), n


def test_train_step_adam_matches_jax(adam_run):
    """Adam (lr 1e-3 backbone, 1e-2 head), 3 augmented steps: the first
    loss rtol 1e-4, every loss rtol 2e-2. Adam's first updates are about
    lr * sign(g), so a gradient near 0 may flip its sign between the
    frameworks: params within 2 * lr * steps of JAX's."""
    steps, _, want_sd, _, tstate = adam_run
    _report(steps, "adam")
    np.testing.assert_allclose(steps[0][1][0], steps[0][0][0], rtol=1e-4)
    for (jl, _), (tl, _) in steps:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
    got = tstate.model.state_dict()
    for n, _ in tstate.model.named_parameters():
        lr = 1e-3 if is_backbone_path(n) else 1e-2
        assert np.abs(got[n].numpy() - want_sd[n].numpy()).max() \
            <= 2 * lr * 3, n


def test_port_warp_is_the_eager_oracle_not_the_jitted_one():
    """The port's warp (and K7, equal to it on the card) computes the
    oracle's float32 operations in order: it equals tpupose's
    batched_affine_warp run eagerly in every element. Jitted, XLA
    contracts the coordinate products into FMAs, so the jitted oracle
    (the one inside tpupose's train step) differs in part of the
    elements by a few 1e-3 on the 0-255 scale; printed with -s."""
    aff, _ = _jax_draws(3, 0, B, 30.0, 0.25, 0.2)
    mats = augment_matrices(aff[0], aff[1], HW).numpy()
    imgs = _batch()["images"]
    port = batched_affine_warp(T(imgs), T(mats), HW).numpy()
    args = (jnp.asarray(imgs, jnp.float32), jnp.asarray(mats))
    eager = np.asarray(j_warp(*args, HW))
    jitted = np.asarray(jax.jit(j_warp, static_argnums=2)(*args, HW))
    np.testing.assert_array_equal(port, eager)
    d = np.abs(jitted - eager)
    print(f"jitted vs eager oracle: {(d > 0).sum()} of {d.size} elements "
          f"differ, max {d.max():.3g}")
    assert d.max() <= 1e-2


@pytest.mark.usefixtures("all_torch_threads")
def test_port_gradients_hold_float64_where_flax_float32_does_not():
    """The floor of the whole-step comparison, pinned: on this test's
    ResNet-18 in train mode (noise pixels, no augmentation), the port's
    float32 gradients are within 1e-4 of a float64 computation (the port
    in float64) in every tensor, while flax's float32 gradients are off
    by more than 10x that: its BatchNorm takes the variance as
    E[x^2] - E[x]^2, whose backward cancels in float32. The stem kernel's
    gradient is left out: it is a sum over every pixel of terms of both
    signs, ill-conditioned in float32 in either framework. Printed with
    -s."""
    from tpupose.ops.preprocess import normalize_images as j_norm

    from tpupose_torch.ops.preprocess import normalize_images

    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(1))
    b = _batch()
    tgt, tw = j_gauss(jnp.asarray(b["joints"]), jnp.asarray(b["visibility"]),
                      HM, 2.0)
    tgt = jnp.transpose(tgt, (0, 2, 3, 1))
    x = j_norm(jnp.asarray(b["images"]))

    def jloss(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          x, train=True, mutable=["batch_stats"])
        return j_mse(out, tgt, tw)

    jg = from_flax_simple_baseline({"params": jax.device_get(
        jax.jit(jax.grad(jloss))(v["params"])),
        "batch_stats": v["batch_stats"]})
    xt = normalize_images(T(b["images"]))
    tt, ttw = T(np.array(tgt)), T(np.array(tw))
    grads = {}
    for dt in (torch.float32, torch.float64):
        m = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=dt,
                           device="cpu")
        m.load_state_dict(from_flax_simple_baseline(v))
        joints_mse_loss(m.train()(xt.to(dt)), tt.to(dt), ttw.to(dt)) \
            .backward()
        grads[dt] = {n: q.grad.double() for n, q in m.named_parameters()}
    err_port = err_jax = 0.0
    for n, g64 in grads[torch.float64].items():
        if n == "backbone.conv1.weight":
            continue
        scale = g64.abs().max().item()
        err_port = max(err_port, (grads[torch.float32][n] - g64).abs().max()
                       .item() / scale)
        err_jax = max(err_jax, (jg[n].double() - g64).abs().max().item()
                      / scale)
    print(f"max relative gradient error vs float64: port float32 "
          f"{err_port:.3g}, flax float32 {err_jax:.3g}")
    assert err_port < 1e-4
    assert err_jax > 10 * err_port


# -- the Trainer on the CPU ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    cfg = default_config()
    cfg.model.backbone = "resnet18"
    cfg.model.num_keypoints = 4
    cfg.model.heatmap_size = (16, 16)
    cfg.model.deconv_channels = (64, 64, 64)
    cfg.data.image_size = (64, 64)
    cfg.data.device_affine = True
    cfg.data.num_workers = 2
    cfg.train.batch_size = 8
    cfg.train.epochs = 2
    cfg.train.warmup_epochs = 0
    cfg.train.mixed_precision = False
    cfg.train.log_interval = 100
    cfg.train.output_dir = str(tmp_path_factory.mktemp("out"))
    cfg.optimizer.name = "adamw"
    cfg.optimizer.lr = 1e-3
    return cfg


@pytest.fixture(scope="module")
def trained(tiny_cfg):
    """Two epochs; after each, a checkpoint with the epoch's mean loss as
    its metric (the best slot takes the lower)."""
    from tpupose_torch.engine.trainer import Trainer

    tr = Trainer(tiny_cfg, device="cpu")
    losses = []
    for epoch in range(2):
        losses.append(tr.iter_one_epoch(epoch))
        tr.save_checkpoint(metric=losses[-1])
    return tr, losses


def test_synthetic_dataset_is_the_jax_one():
    a, b = SyntheticTopDownDataset(3, (64, 48), (16, 12), 5, seed=2), \
        JSynthetic(3, (64, 48), (16, 12), 5, seed=2)
    for i in range(3):
        for k, v in b[i].items():
            np.testing.assert_array_equal(a[i][k], v)


def test_tensorboard_events_read_by_the_jax_reader(tmp_path):
    """The port's copy of the tfevents writer writes what
    tpupose.utils.tensorboard.read_scalars reads back."""
    from tpupose.utils.tensorboard import read_scalars

    from tpupose_torch.utils.tensorboard import SummaryWriter

    with SummaryWriter(str(tmp_path)) as w:
        w.add_scalars({"loss": 0.25, "grad_norm": 1.5}, 3, prefix="train/")
        w.add_scalar("val/loss", 0.125, 4)
    (path,) = tmp_path.iterdir()
    assert sorted(read_scalars(str(path))) == sorted(
        [("train/loss", 0.25, 3), ("train/grad_norm", 1.5, 3),
         ("val/loss", 0.125, 4)])


def test_trainer_loss_decreases_and_validates(trained):
    tr, (l0, l1) = trained
    assert tr.steps_per_epoch == 32
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, f"loss did not decrease: {l0} -> {l1}"
    assert np.isfinite(tr.validate())
    assert tr.img_per_s > 0


def test_trainer_checkpoint_round_trip_is_exact(trained, tiny_cfg):
    """A fresh Trainer restores the step, every parameter and buffer and
    the optimizer state, and its next step equals the original's."""
    from tpupose_torch.engine.trainer import Trainer

    tr, _ = trained
    tr2 = Trainer(tiny_cfg, device="cpu")
    assert tr2.load_checkpoint() == tr.state.step == tr2.state.step
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = tr.state.optimizer.state_dict(), tr2.state.optimizer.state_dict()
    assert s1["count"] == s2["count"]
    for i, st in s1["inner"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(s2["inner"]["state"][i][k]))
    batch = next(iter(tr.train_loader))
    m1 = tr.train_step(tr.state, tr._prepare_batch(batch))
    m2 = tr2.train_step(tr2.state, tr2._prepare_batch(batch))
    assert m1["loss"].item() == m2["loss"].item()
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a, b)


def test_trainer_best_slot(trained, tiny_cfg):
    """`<ckpt dir>@best` restores the best-by-metric slot (the lower
    epoch loss, saved at step 64), not the latest periodic checkpoint."""
    from tpupose_torch.engine.trainer import Trainer

    tr, _ = trained
    assert tr.ckpt.best_step == 64
    tr.train_step(tr.state, tr._prepare_batch(next(iter(tr.train_loader))))
    tr.save_checkpoint()                     # periodic, later, no metric
    tr2 = Trainer(tiny_cfg, device="cpu")
    assert tr2.load_checkpoint() == tr.state.step > 64
    assert tr2.load_checkpoint(tr.ckpt.directory + "@best") == 64
    assert tr2.state.step == 64
    assert tr2.load_checkpoint("@best") == 64


def test_trainer_checkpoints_on_a_deferred_signal(trained):
    """SIGTERM during train() is deferred to the next step boundary, where
    the trainer saves a resumable checkpoint and exits 128 + signum."""
    import signal

    tr, _ = trained
    tr._exit_signal = signal.SIGTERM
    try:
        with pytest.raises(SystemExit) as exc:
            tr._check_exit_signal()
    finally:
        tr._exit_signal = None
    assert exc.value.code == 128 + signal.SIGTERM
    assert tr.ckpt.latest_step() == tr.state.step


def test_cli_trains_one_epoch_on_cpu(tmp_path):
    from tpupose_torch.cli.train import main

    out = tmp_path / "cli"
    assert main(["--cfg", "tpupose/configs/method/simple_baseline.yaml",
                 "--device", "cpu", "model.backbone=resnet18",
                 "model.num_keypoints=4", "model.heatmap_size=[16,16]",
                 "model.deconv_channels=[32,32,32]",
                 "data.image_size=[64,64]", "data.device_affine=true",
                 "train.batch_size=16", "train.epochs=1",
                 "train.mixed_precision=false", f"train.output_dir={out}"]) \
        == 0
    assert (out / "default" / "ckpt" / "periodic" / "16.pt").exists()
