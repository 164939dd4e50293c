"""HRNet in the port (models/backbones/hrnet.py, models/remat.py,
utils/convert.from_flax_hrnet, and the builder, trainer, evaluator and
serving CLI on it) held against the JAX package on the CPU.

The models are tiny: a width-8 HRNet with one module per stage
("hrnet_t8", added to both packages' HRNET_SPECS for this file), inputs
from numpy seeds, float32 throughout. Tolerances, with their reasons:
  - the forward: 1e-4 of the heatmaps' range (float32 sums in another
    order);
  - the train step against JAX's: tests/test_torch_hrnet_train.py;
  - remat against the plain step: 1e-5 of each tensor's range, and the
    running statistics updated once (num_batches_tracked equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.data.synthetic import SyntheticTopDownDataset as JSynthetic
from tpupose.models.backbones import hrnet as jhrnet
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_train_step)
from tpupose_torch.losses.heatmap import joints_mse_loss
from tpupose_torch.models.backbones import hrnet as thrnet
from tpupose_torch.models.backbones.hrnet import HRNetPose
from tpupose_torch.utils.convert import from_flax_hrnet

from test_torch_model import _randomize_bn
from test_torch_quant import K, one_torch_thread, tiny_spec  # noqa: F401

T = torch.from_numpy


def _flax_hrnet(hw=(64, 48), seed=0):
    """A flax HRNetPose t8 (float32) with non-trivial BatchNorm
    statistics, as numpy arrays."""
    jm = jhrnet.HRNetPose(variant="hrnet_t8", num_keypoints=K,
                          dtype=jnp.float32)
    init = jax.jit(jm.init, static_argnames="train")
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    return jm, _randomize_bn(v, np.random.RandomState(seed + 1))


@pytest.fixture(scope="module")
def pair(tiny_spec):
    jm, v = _flax_hrnet()
    tm = HRNetPose("hrnet_t8", K, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_hrnet(v))
    return jm, v, tm


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_from_flax_hrnet_maps_every_leaf(pair):
    """Every port tensor gets a value and every flax leaf is used once:
    the flax leaves' sizes add up to the port's parameters and running
    statistics; every conv has its flax module path."""
    jm, v, tm = pair
    paths = {}
    sd = from_flax_hrnet(v, paths)
    want = tm.state_dict()
    assert set(sd) == set(want)
    n_flax = sum(a.size for a in _leaves(v))
    n_port = sum(t.numel() for k, t in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port
    for k, t in sd.items():
        assert t.shape == want[k].shape, k
    convs = {n for n, m in tm.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    assert set(paths) == convs
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    kernels = {"/".join(p.key for p in path[:-1]) for path, _ in flat
               if path[-1].key == "kernel"}
    assert set(paths.values()) == kernels


@pytest.mark.parametrize("hw", [(64, 48), (64, 64)], ids=["64x48", "64x64"])
def test_forward_matches_jax(hw):
    """64x48 makes the fuse ratios non-integer (a 2x2 branch against a
    4x3 one); 64x64 keeps them integer."""
    jm, v = _flax_hrnet(hw, seed=3)
    tm = HRNetPose("hrnet_t8", K, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_hrnet(v))
    x = np.random.RandomState(4).normal(0, 1, (2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a: jm.apply(v, a, train=False))(x))
    got = tm(T(x)).detach().numpy()
    assert got.shape == want.shape == (2, hw[0] // 4, hw[1] // 4, K)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


@pytest.mark.parametrize("src,dst", [((2, 2), (4, 3)), ((13, 13), (25, 25)),
                                     ((7, 7), (25, 25)), ((4, 4), (13, 13)),
                                     ((3, 5), (12, 20))])
def test_nearest_upsample_is_jax_resize(src, dst):
    """The model's _upsample_to and the engine's int8 gather equal
    jax.image.resize(..., "nearest") at integer and non-integer ratios
    (torch's mode="nearest" does not at the non-integer ones)."""
    from tpupose_torch.ops.int8_engine import _upsample_nearest

    x = np.random.RandomState(5).normal(0, 1, (2, *src, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), method="nearest"))
    got = thrnet._upsample_to(T(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    q = T((x * 40).astype(np.int8))
    np.testing.assert_array_equal(
        _upsample_nearest(q, dst).numpy(),
        np.asarray(jax.image.resize(q.numpy(), (2, *dst, 3),
                                    method="nearest")))


def test_head_runs_in_float32_outside_autocast():
    """bf16 autocast over float32 masters: the backbone's output is bf16,
    the head's float32 (flax's nn.Conv(..., dtype=float32))."""
    tm = HRNetPose("hrnet_t8", K, dtype=torch.bfloat16, device="cpu",
                   param_dtype=torch.float32)
    seen = {}
    tm.final_layer.register_forward_hook(
        lambda m, a, o: seen.update(x=a[0].dtype, y=o.dtype))
    out = tm(torch.zeros(1, 64, 48, 3))
    assert seen == {"x": torch.float32, "y": torch.float32}
    assert out.dtype == torch.float32
    assert next(tm.backbone.parameters()).dtype == torch.float32
    assert tm.final_layer.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert not any(n.startswith("backbone.") for n, _ in
                   tm.final_layer.named_parameters(prefix="final_layer"))


# -- the train steps' batch (also tests/test_torch_hrnet_train.py's) -------

# B = 16: the lowest branch's BatchNorm then sees 16 x 2 x 2 values per
# channel (at B = 4, 16 values, and the warp's one-ulp input changes, see
# tests/test_torch_train.py, moved the first loss by 3e-4)
B, HW, HM = 16, (64, 48), (16, 12)
AUG = dict(color_jitter_strength=0.2, jitter_seed=3, heatmap_size=HM,
           sigma=2.0, affine_rotation=30.0, affine_scale=0.25)


def _batch(hw=HW, hm=HM):
    """Synthetic joints, noise pixels (see tests/test_torch_train.py)."""
    ds = JSynthetic(B, hw, hm, K, seed=0)
    s = [ds[i] for i in range(B)]
    rs = np.random.RandomState(5)
    return {"images": rs.randint(0, 256, (B, *hw, 3)).astype(np.uint8),
            "joints": np.stack([x["joints"] for x in s]),
            "visibility": np.stack([x["visibility"] for x in s])}


# -- remat ---------------------------------------------------------------------

def _remat_models(kind):
    g = torch.Generator().manual_seed(11)
    if kind == "hrnet":
        from tpupose_torch.models.backbones.hrnet import HRNetPose as M

        mk = lambda r: M("hrnet_t8", K, dtype=torch.float32,  # noqa: E731
                         device="cpu", remat=r)
    else:
        from tpupose_torch.models.simple_baseline import SimpleBaseline as M

        mk = lambda r: M("resnet18", K, (16, 16, 16),  # noqa: E731
                         dtype=torch.float32, device="cpu", remat=r)
    plain = mk(False)
    from tpupose_torch.models.simple_baseline import _init_from_generator

    _init_from_generator(plain, g)
    remat = mk(True)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


@pytest.mark.parametrize("kind", ["hrnet", "resnet18"])
def test_remat_step_equals_plain_step(kind, monkeypatch):
    """One Adam step with device affine through each: every parameter
    and running statistic within 1e-5 of its range, the checkpoint
    really taken, and each BatchNorm's statistics updated once
    (torch.utils.checkpoint's recomputation would update them again)."""
    import tpupose_torch.models.remat as remat_mod

    calls = []
    real = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    hw, hm = ((64, 48), (16, 12)) if kind == "hrnet" else ((64, 64),
                                                           (16, 16))
    batch = {k: T(a) for k, a in _batch(hw, hm).items()}
    out = {}
    for m in _remat_models(kind):
        opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-3),
                             m.named_parameters(), grad_clip_norm=10.0)
        step = make_heatmap_train_step(joints_mse_loss,
                                       **dict(AUG, heatmap_size=hm))
        n0 = len(calls)
        met = step(TrainState(m, opt), batch)
        out[m.backbone.remat] = (m.state_dict(), met["loss"].item(),
                                 len(calls) - n0)
    (plain, lp, c0), (remat, lr_, c1) = out[False], out[True]
    n_blocks = (4 + 2 + 3 + 4) if kind == "hrnet" else 8
    assert c0 == 0 and c1 == n_blocks
    assert lr_ == pytest.approx(lp, rel=1e-6)
    for k, w in plain.items():
        g = remat[k]
        if k.endswith("num_batches_tracked"):
            assert int(g) == int(w) == 1, k
            continue
        assert (g - w).abs().max() <= 1e-5 * max(w.abs().max(), 1e-12), k


def test_checkpoint_alone_updates_batchnorm_twice():
    """The trap itself, pinned: a bare torch.utils.checkpoint of a block
    (BatchNorm, ReLU, conv) updates the port BatchNorm2d's statistics in
    the recomputation too; block_call does not."""
    from torch.utils.checkpoint import checkpoint

    from tpupose_torch.models.backbones.resnet import BatchNorm2d
    from tpupose_torch.models.remat import block_call

    x = torch.randn(4, 3, 5, 5, requires_grad=True)
    for fn, want in (
            (lambda blk: checkpoint(blk, x, use_reentrant=False), 2),
            (lambda blk: block_call(blk, x, True), 1)):
        blk = torch.nn.Sequential(BatchNorm2d(3), torch.nn.ReLU(),
                                  torch.nn.Conv2d(3, 3, 1)).train()
        fn(blk).sum().backward()
        assert int(blk[0].num_batches_tracked) == want


# -- builder, trainer, evaluate, serve ------------------------------------------

W32 = "tpupose/configs/method/hrnet_w32.yaml"
W48 = "tpupose/configs/method/hrnet_w48_384.yaml"


def _n_flax_params(name, hw):
    jm = jhrnet.HRNetPose(variant=name, num_keypoints=17, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), train=False))
    return sum(int(np.prod(a.shape)) for a in _leaves(shapes["params"]))


@pytest.mark.parametrize("path,name,hw", [(W32, "hrnet_w32", (256, 192)),
                                          (W48, "hrnet_w48", (384, 288))],
                         ids=["w32", "w48"])
def test_builder_builds_the_graded_configs(path, name, hw):
    """Builder(cfg).model() on the two yamls: an HRNetPose of the yaml's
    variant, float32 masters under bf16 autocast, as many parameters as
    the flax model, and the head outside the backbone group."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder

    cfg = load_config(path, {})
    m = Builder(cfg, "cpu").model()
    assert isinstance(m, HRNetPose) and m.backbone_name == name
    assert m.compute_dtype == torch.bfloat16
    assert next(m.parameters()).dtype == torch.float32
    assert sum(p.numel() for p in m.parameters()) == _n_flax_params(name, hw)
    heads = [n for n, _ in m.named_parameters() if not is_backbone_path(n)]
    assert heads == ["final_layer.weight", "final_layer.bias"]


def _tiny_cfg(tmp_path, *extra):
    from tpupose_torch.configs import load_config

    over = {"data.name": "synthetic", "model.backbone": "hrnet_t8",
            "data.image_size": "[64, 48]", "model.heatmap_size": "[16, 12]",
            "train.batch_size": "16", "train.epochs": "1",
            "train.warmup_epochs": "0", "train.mixed_precision": "false",
            "train.log_interval": "100", "eval.batch_size": "32",
            "train.output_dir": str(tmp_path)}
    over.update(dict(e.split("=", 1) for e in extra))
    return load_config(W32, over)


def test_trainer_trains_and_evaluates_hrnet_on_the_cpu(tmp_path):
    """The hrnet_w32 yaml (device affine on) at tiny size: a finite,
    falling loss over two epochs, remat on, and a finite evaluate()."""
    from tpupose_torch.engine.trainer import Trainer

    tr = Trainer(_tiny_cfg(tmp_path, "train.epochs=2", "train.remat=true"),
                 device="cpu")
    assert tr.model.backbone.remat is True
    losses = [tr.iter_one_epoch(e) for e in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    out = tr.evaluate()
    assert {"pck", "mpjpe", "mAP"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())


def test_cli_serve_answers_with_hrnet(tmp_path):
    """cli.serve on the hrnet_w32 yaml (tiny): flip requests answered on
    the model's forward (never the R50's stem/layer1/bridge route) and on
    the Int8Engine."""
    from tpupose_torch.cli.serve import build_predictor
    from tpupose_torch.ops.int8_engine import Int8Engine

    crops = np.random.RandomState(9).randint(0, 256, (3, 64, 48, 3)) \
        .astype(np.uint8)
    for int8 in ("false", "true"):
        pred = build_predictor(_tiny_cfg(tmp_path,
                                         f"eval.int8_engine={int8}"),
                               "", "cpu")
        assert isinstance(pred.evaluator.model, HRNetPose)
        assert pred.evaluator.fast_weights is None      # K1-K3 are R50's
        assert isinstance(pred.evaluator.int8_engine, Int8Engine) \
            is (int8 == "true")
        c, s = pred(crops)
        assert c.shape == (3, 17, 2) and s.shape == (3, 17)
        assert np.isfinite(c).all() and np.isfinite(s).all()
