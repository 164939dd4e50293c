"""Coordinate regression in the port (losses/heatmap.coord_mse_loss,
losses/rle.py, models/heads.RegressionHead / ClassifyHead,
models/deeppose.py, utils/convert.from_flax_deeppose, the regression and
RLE train steps, Trainer.evaluate_regression, the Builder) held against
the JAX package on the CPU, float32, on numpy seeded inputs and flax
weights carried across by the converter.

DeepPose on a ResNet-18 at 64x64, K = 16 (MPII's head joints 8/9 make
PCKh apply). Tolerances, with their reasons:
  - the losses: float32 sums in another order, rtol 3e-6; gradients
    elementwise, 1e-6 of their max (1e-5 through the flow's tanh
    layers);
  - the flow's log-density and the forwards: 1e-5 / 1e-4 of the range
    (float32 sums in another order);
  - the steps: the first loss 1e-4, grad norms 2e-2 (the R50 steps'
    bounds), the state within 1e-4 of the port's own float64 run;
  - evaluate(): every metric within 1e-4 (test_torch_evaluate's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_regression_train_step as j_reg
from tpupose.engine.train_state import make_rle_train_step as j_rle_step
from tpupose.losses.heatmap import coord_mse_loss as j_coord
from tpupose.losses.rle import RealNVP as JRealNVP
from tpupose.losses.rle import rle_loss as j_rle
from tpupose.models.deeppose import DeepPose as JDeepPose
from tpupose.models.heads import ClassifyHead as JClassifyHead
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import (TrainState,
                                              make_regression_train_step,
                                              make_rle_train_step)
from tpupose_torch.losses.heatmap import coord_mse_loss
from tpupose_torch.losses.rle import RealNVP, rle_loss
from tpupose_torch.models.deeppose import DeepPose
from tpupose_torch.models.heads import ClassifyHead
from tpupose_torch.utils.convert import (_with_bias, conv_weight,
                                         from_flax_deeppose)

from test_torch_model import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
K = 16
HW = (64, 64)


def _coords(seed=0, B=3):
    rs = np.random.RandomState(seed)
    pred = rs.uniform(-0.2, 1.2, (B, K, 2)).astype(np.float32)
    tgt = rs.uniform(0, 1, (B, K, 2)).astype(np.float32)
    vis = (rs.uniform(size=(B, K)) > 0.3).astype(np.float32)
    return pred, tgt, vis


@pytest.mark.parametrize("masked", [True, False])
def test_coord_mse_and_gradient_match_jax(masked):
    pred, tgt, vis = _coords()
    v = vis if masked else None
    jv, jg = jax.value_and_grad(lambda p: j_coord(p, tgt, v))(
        jnp.asarray(pred))
    p = T(pred).requires_grad_(True)
    out = coord_mse_loss(p, T(tgt), None if v is None else T(v))
    out.backward()
    np.testing.assert_allclose(out.item(), float(jv), rtol=3e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())


def _flow_pair(seed=1):
    """A flax RealNVP (3 couplings) with every Dense, the zero-initialised
    scale and shift layers included, drawn at random, and its port twin."""
    jf = JRealNVP(layers=3)
    v = jf.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2)))
    rs = np.random.RandomState(seed)
    # kernels at 0.7 / sqrt(fan_in), biases at 0.1: the tanh layers stay
    # off saturation, where 1 - tanh^2 would magnify XLA's tanh
    # approximation error
    v = jax.tree_util.tree_map(
        lambda a: (rs.normal(0, 0.7 / np.sqrt(a.shape[0]) if a.ndim == 2
                             else 0.1, a.shape)).astype(np.float32), v)
    tf = RealNVP(layers=3)
    sd = {}
    for i in range(3):
        for j in range(4):
            _with_bias(sd, f"couplings.{i}.layers.{j}",
                       v["params"][f"_Coupling_{i}"][f"Dense_{j}"], None, "",
                       dense=True)
    tf.load_state_dict(sd)
    return jf, v, tf


def test_realnvp_log_density_and_gradients_match_jax():
    jf, v, tf = _flow_pair()
    r = np.random.RandomState(2).normal(0, 1.5, (40, 2)).astype(np.float32)
    want, (gv, gr) = jax.value_and_grad(
        lambda vv, rr: jf.apply(vv, rr).sum(), argnums=(0, 1))(
        v, jnp.asarray(r))
    rt = T(r).requires_grad_(True)
    got = tf(rt)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jf.apply(v, jnp.asarray(r))),
        rtol=0, atol=1e-5 * np.abs(np.asarray(jf.apply(v, r))).max())
    got.sum().backward()
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(gr), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gr)).max())
    for i in range(3):
        for j in range(4):
            lin = tf.couplings[i].layers[j]
            want_k = np.asarray(gv["params"][f"_Coupling_{i}"][f"Dense_{j}"]
                                ["kernel"]).T
            np.testing.assert_allclose(lin.weight.grad.numpy(), want_k,
                                       rtol=0,
                                       atol=1e-5 * np.abs(want_k).max() + 1e-7)


def test_fresh_flow_is_the_identity():
    """The zero-initialised scale and shift layers: log-density is the
    standard normal's, as flax's zero kernels give."""
    r = np.random.RandomState(3).normal(0, 1, (8, 2)).astype(np.float32)
    got = RealNVP()(T(r)).detach().numpy()
    want = -0.5 * (r ** 2).sum(-1) - np.log(2 * np.pi)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("q", ["laplace", "gaussian"])
@pytest.mark.parametrize("residual", [True, False])
def test_rle_loss_and_gradients_match_jax(q, residual):
    mu, tgt, vis = _coords(4)
    rs = np.random.RandomState(5)
    sigma = rs.uniform(0.05, 0.9, mu.shape).astype(np.float32)
    log_phi = rs.normal(-2, 1, vis.shape).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a, b, c: j_rle(a, b, c, tgt, vis, residual=residual, q=q),
        argnums=(0, 1, 2))(jnp.asarray(mu), jnp.asarray(sigma),
                           jnp.asarray(log_phi))
    args = [T(a).requires_grad_(True) for a in (mu, sigma, log_phi)]
    out = rle_loss(*args, T(tgt), T(vis), residual=residual, q=q)
    out.backward()
    np.testing.assert_allclose(out.item(), float(jv), rtol=3e-6)
    for a, g in zip(args, jg):
        g = np.asarray(g)
        # without the residual term mu reaches the loss only through
        # log_phi, an input here: no gradient (JAX's zeros)
        got = a.grad.numpy() if a.grad is not None else np.zeros_like(g)
        np.testing.assert_allclose(got, g, rtol=0,
                                   atol=1e-6 * np.abs(g).max())
    with pytest.raises(ValueError, match="q distribution"):
        rle_loss(*args, T(tgt), q="cauchy")


# -- DeepPose -------------------------------------------------------------------

def _flax_deeppose(rle, seed=0, random_heads=False):
    jm = JDeepPose(backbone="resnet18", num_keypoints=K, rle=rle,
                   dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(seed + 1))
    if random_heads and rle:
        rs = np.random.RandomState(seed + 2)
        for sub in ("rle_head", "flow"):
            v["params"][sub] = jax.tree_util.tree_map(
                lambda a: (rs.normal(0, 0.05, a.shape)).astype(np.float32),
                v["params"][sub])
    return jm, v


def _port_deeppose(rle, v, dtype=torch.float32):
    tm = DeepPose("resnet18", K, rle=rle, dtype=dtype, device="cpu")
    tm.load_state_dict(from_flax_deeppose(v))
    return tm


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
def test_deeppose_converter_and_forward_match_jax(rle):
    """Every leaf used once and every port tensor set; (B, K, 2) coords,
    or (mu, sigma) and with a target (mu, sigma, log_phi), equal to
    flax's (the RLE head and flow drawn at random, not at their zero
    init)."""
    jm, v = _flax_deeppose(rle, seed=3, random_heads=True)
    tm = _port_deeppose(rle, v)
    paths = {}
    sd = from_flax_deeppose(v, paths)
    assert set(sd) == set(tm.state_dict())
    assert sum(a.size for a in jax.tree_util.tree_leaves(v)) == sum(
        t.numel() for k, t in sd.items()
        if not k.endswith("num_batches_tracked"))
    assert set(paths) == {n for n, m in tm.named_modules()
                          if isinstance(m, (torch.nn.Conv2d,
                                            torch.nn.Linear))}
    rs = np.random.RandomState(4)
    x = rs.normal(0, 1, (2, *HW, 3)).astype(np.float32)
    tgt = rs.uniform(0, 1, (2, K, 2)).astype(np.float32)
    want = jm.apply(v, x, train=False)
    got = tm(T(x))
    if not rle:
        want, got = (want,), (got,)
    else:
        want = tuple(want) + (jm.apply(v, x, train=False, target=tgt)[2],)
        got = tuple(got) + (tm(T(x), target=T(tgt))[2],)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.detach().numpy() - w).max() / np.abs(w).max() < 1e-4


def test_heads_run_in_float32_under_autocast():
    for rle in (False, True):
        tm = DeepPose("resnet18", K, rle=rle, dtype=torch.bfloat16,
                      device="cpu", param_dtype=torch.float32)
        out = tm(torch.zeros(1, *HW, 3))
        outs = out if rle else (out,)
        assert all(o.dtype == torch.float32 for o in outs)
        if rle:    # the zero init: mu 0, sigma 0.5
            assert float(outs[0].abs().max()) == 0.0
            assert torch.all(outs[1] == 0.5)


def test_classify_head_matches_jax():
    """NCHW in the port (the flax head takes NHWC): conv 1x1 + SiLU +
    GAP + linear, eval mode (dropout off) equal to flax's; in train mode
    the dropout draws differ and only the shape is held."""
    jh = JClassifyHead(num_classes=5, hidden=32, dropout=0.25,
                       dtype=jnp.float32)
    x = np.random.RandomState(6).normal(0, 1, (3, 6, 5, 8)).astype(
        np.float32)
    v = jh.init(jax.random.PRNGKey(0), x, train=False)
    th = ClassifyHead(8, 5, hidden=32, dropout=0.25)
    sd = {"conv.weight": conv_weight(v["params"]["Conv_0"]["kernel"]),
          "conv.bias": T(np.array(v["params"]["Conv_0"]["bias"]))}
    _with_bias(sd, "fc", v["params"]["Dense_0"], None, "", dense=True)
    th.load_state_dict(sd)
    want = np.asarray(jh.apply(v, x, train=False))
    got = th.eval()(T(x).permute(0, 3, 1, 2)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert th.train()(T(x).permute(0, 3, 1, 2)).shape == (3, 5)


# -- the regression and RLE train steps -----------------------------------------

B = 4


def _batch():
    rs = np.random.RandomState(7)
    return {"images": rs.randint(0, 256, (B, *HW, 3)).astype(np.uint8),
            "target_coords": rs.uniform(0.1, 0.9, (B, K, 2)).astype(
                np.float32),
            "visibility": (rs.uniform(size=(B, K)) > 0.2).astype(
                np.float32)}


def _run(rle):
    """2 steps of tpupose's jitted step and of the port's in float32 and
    float64, SGD (momentum 0.9, clip 10, lr 1e-3 / 2e-3) from the same
    flax init (BN statistics randomized, the RLE head and flow at their
    zero init)."""
    jm, v = _flax_deeppose(rle)
    kw = dict(name="sgd", lr=1e-3, head_lr=2e-3, momentum=0.9)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0)
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               jnp.zeros((1, *HW, 3)), tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, v["batch_stats"]), opt_state=tx.init(params))
    if rle:
        jstep = j_rle_step(lambda *a: j_rle(*a))
        tstep = make_rle_train_step(rle_loss)
    else:
        jstep, tstep = j_reg(j_coord), make_regression_train_step(
            coord_mse_loss)
    tstates = {}
    for dt in (torch.float32, torch.float64):
        m = _port_deeppose(rle, v, dtype=dt)
        tstates[dt] = TrainState(m, make_optimizer(
            OptimizerConfig(**kw), m.named_parameters(),
            is_head=lambda n: not is_backbone_path(n), grad_clip_norm=10.0))
    batch = _batch()
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    out = []
    for _ in range(2):
        state, jmet = jstep(state, jb)
        tmet = {dt: tstep(ts, tb) for dt, ts in tstates.items()}
        out.append(((float(jmet["loss"]), float(jmet["grad_norm"])),
                    (tmet[torch.float32]["loss"].item(),
                     tmet[torch.float32]["grad_norm"].item())))
    want = from_flax_deeppose({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(
                                   state.batch_stats)})
    return out, want, {dt: ts.model.state_dict()
                       for dt, ts in tstates.items()}


@pytest.mark.parametrize("rle", [False, True], ids=["coord_mse", "rle"])
def test_train_steps_match_jax(rle):
    """Losses and grad norms: the first loss rtol 1e-4, the second 1e-3,
    grad norms 2e-2. The state after 2 steps: the port's float32 run and
    JAX's each within 1e-4 of each tensor's max of the port's float64
    run. Printed with -s."""
    steps, want_sd, got = _run(rle)
    for t, ((jl, jg), (tl, tg)) in enumerate(steps):
        print(f"{'rle' if rle else 'coord_mse'} step {t}: loss rel "
              f"{abs(tl / jl - 1):.3g}, grad_norm rel {abs(tg / jg - 1):.3g}")
    np.testing.assert_allclose(steps[0][1][0], steps[0][0][0], rtol=1e-4)
    np.testing.assert_allclose(steps[1][1][0], steps[1][0][0], rtol=1e-3)
    for (jl, jg), (tl, tg) in steps:
        np.testing.assert_allclose(tg, jg, rtol=2e-2)
    worst = {"port": 0.0, "jax": 0.0}
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = got[torch.float64][k].double().numpy()
        scale = max(np.abs(ref).max(), 1e-12)
        for name, t in (("port", got[torch.float32][k].numpy()),
                        ("jax", w.numpy())):
            worst[name] = max(worst[name], np.abs(t - ref).max() / scale)
    print(f"state after 2 steps vs the port in float64: {worst}")
    assert worst["port"] <= 1e-4 and worst["jax"] <= 1e-4, worst


# -- Builder and Trainer --------------------------------------------------------

YAML = "tpupose/configs/method/deep_pose.yaml"
TINY = ("model.backbone=resnet18", "data.image_size=[64,64]",
        "model.heatmap_size=[16,16]", "train.mixed_precision=false",
        "train.batch_size=16", "train.epochs=2", "train.warmup_epochs=0",
        "train.log_interval=100", "eval.batch_size=16",
        "eval.metrics=['pck','pckh','mpjpe','auc','epe','oks_ap']")


def _cfgs(*over):
    from tpupose.configs import load_config as jload
    from tpupose_torch.configs import parse_args, update_config
    from tpupose_torch.configs.default import default_config

    args = parse_args(["--cfg", YAML, "--device", "cpu", *over])
    d = dict(o.split("=", 1) for o in over)
    return update_config(default_config(), args), jload(YAML, d)


@pytest.mark.parametrize("loss", ["coord_mse", "rle"])
def test_builder_on_the_yaml(loss):
    """deep_pose.yaml at full width (R50, K = 16): loss rle gives the
    (mu, sigma) head and the flow, coord_mse the RegressionHead; the
    losses are the port's, bound to rle_residual / rle_q."""
    from tpupose_torch.engine.builder import Builder

    cfg, _ = _cfgs(f"loss.name={loss}", "loss.rle_q=gaussian")
    b = Builder(cfg, "cpu")
    m = b.model()
    assert isinstance(m, DeepPose) and m.backbone_name == "resnet50"
    assert m.rle == (loss == "rle") and m.num_keypoints == 16
    fn = b.loss()
    if loss == "rle":
        assert fn.func is rle_loss and fn.keywords == {"residual": True,
                                                       "q": "gaussian"}
        assert float(m.rle_head.weight.abs().max()) == 0.0
    else:
        assert fn is coord_mse_loss


@pytest.mark.parametrize("loss", ["coord_mse", "rle"])
def test_trainer_evaluate_matches_jax(loss, tmp_path):
    """JAX's Trainer and the port's on the tiny config, the JAX weights
    carried across: val_loss, PCK, PCKh (K = 16 > 9), MPJPE, AUC and EPE
    in source pixels within 1e-4; oks_ap skipped by both."""
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.trainer import Trainer as PTrainer

    pc, jc = _cfgs(*TINY, f"loss.name={loss}",
                   f"train.output_dir={tmp_path}")
    jt, pt = JTrainer(jc), PTrainer(pc, device="cpu")
    assert pt.family == ("rle" if loss == "rle" else "regression")
    pt.model.load_state_dict(from_flax_deeppose(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}))
    want, got = jt.evaluate(), pt.evaluate()
    assert sorted(got) == sorted(want)
    assert {"val_loss", "pck", "pckh", "mpjpe", "auc", "epe"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)


def test_trainer_trains_and_skips_pckh_below_ten_joints(tmp_path, capsys):
    """Two epochs of coord_mse at K = 4 on 64 synthetic crops (Adam; the
    yaml's RMSprop takes longer than 8 steps to settle): finite, falling
    losses;
    evaluate() warns that PCKh needs the MPII head joints and leaves it
    out."""
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.trainer import Trainer

    class Small(Builder):
        def dataset(self, split="train"):
            return SyntheticTopDownDataset(
                64 if split == "train" else 16, HW, (16, 16), 4,
                seed=0 if split == "train" else 1)

    cfg, _ = _cfgs(*TINY, "model.num_keypoints=4", "optimizer.name=adam",
                   "optimizer.lr=1e-3", f"train.output_dir={tmp_path}")
    tr = Trainer(cfg, builder=Small(cfg, "cpu"), device="cpu")
    losses = [tr.iter_one_epoch(e) for e in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
    out = tr.evaluate()
    assert "pckh" not in out and {"pck", "mpjpe"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
    assert "PCKh needs the MPII head" in capsys.readouterr().out
