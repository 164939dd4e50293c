"""DINOv3Pose in the port (models/necks.py, models/backbones/convnext.py,
models/yolo_head.py, models/dinov3_pose.py, utils/convert.
from_flax_dinov3_pose and the builder's dinov3_pose branch) held against
the JAX package on the CPU.

The models are small: ConvNeXt "atto" with neck (48, 96, 192), as
tests/test_yolo_pose.py builds it, and ViT "small" (64x64 input: 4x4
token maps resized to 8x8, 4x4 and 2x2, so the antialiased downsample
runs), each with reg_max 0 and 16; flax's init with non-trivial
BatchNorm statistics and, for the ViT, layer scales drawn in U(0.2, 0.6)
(flax's 1e-5 would make every block nearly the identity), carried across
by from_flax_dinov3_pose; inputs from numpy seeds; float32 throughout.

Tolerances, with their reasons:
  - eval-mode forward, features, running statistics: 1e-5 of the
    largest |value| of the compared tensor (float32 sums in another
    order; the readings are 1e-7 of it, 3e-6 for the statistics);
  - train-mode maps: 5e-5 of it (flax's float32 batch variance is
    E[x^2] - E[x]^2, which cancels: the ViT's maps read 1.2e-5; ROADMAP
    Queue C has the same for its backward);
  - the bilinear resize and dist2bbox: 1e-6 absolute, the DFL integral
    1e-6 relative (a few float32 operations; the softmax sums in another
    order); the anchors exactly;
  - the full-width configs: parameter counts equal flax's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.engine.builder import Builder as JBuilder
from tpupose.models import yolo_head as jhead
from tpupose.models.dinov3_pose import DINOv3Pose as JDINOv3Pose
from tpupose_torch.configs import load_config
from tpupose_torch.engine.builder import Builder, is_backbone_path
from tpupose_torch.models import yolo_head as thead
from tpupose_torch.models.backbones.vit import LayerScale
from tpupose_torch.models.dinov3_pose import DINOv3Pose
from tpupose_torch.models.necks import ConvNeXtBlock, resize_to
from tpupose_torch.utils.convert import from_flax_dinov3_pose

from test_torch_model import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401

NECK = (48, 96, 192)
# the head does not see the backbone and the backbone not reg_max: three
# cases cover both backbones and both head variants
CASES = [("dinov3_convnext_atto", 0), ("dinov3_convnext_atto", 16),
         ("dinov3_vit_small", 0)]
IDS = [f"{b.split('_')[1]}-reg{r}" for b, r in CASES]


def _randomize_layer_scales(tree, rs):
    """ViT layer scales ls1/ls2 drawn in U(0.2, 0.6)."""
    vp = tree["params"].get("DinoViT_0", {})
    for blk in vp.values():
        if isinstance(blk, dict) and "ls1" in blk:
            for k in ("ls1", "ls2"):
                blk[k] = rs.uniform(0.2, 0.6, blk[k].shape).astype(
                    np.float32)
    return tree


def flax_dinov3(backbone, reg_max, seed=0, hw=(64, 64)):
    """(flax DINOv3Pose, numpy variables) at float32."""
    jm = JDINOv3Pose(backbone=backbone, num_keypoints=4, num_classes=7,
                     neck_channels=NECK, reg_max=reg_max, dtype=jnp.float32)
    init = jax.jit(jm.init, static_argnames="train")
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(seed + 1))
    return jm, _randomize_layer_scales(v, np.random.RandomState(seed + 2))


def port_dinov3(backbone, reg_max, v, paths=None):
    tm = DINOv3Pose(backbone, 4, 7, NECK, reg_max=reg_max,
                    dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_dinov3_pose(v, paths))
    return tm


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request):
    backbone, reg_max = request.param
    jm, v = flax_dinov3(backbone, reg_max)
    paths = {}
    return jm, v, port_dinov3(backbone, reg_max, v, paths), paths


def _images(n=2, seed=3, hw=(64, 64)):
    return np.random.RandomState(seed).uniform(
        0, 1, (n, *hw, 3)).astype(np.float32)


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / den
    assert err <= rel, f"max err {err:.3g} of max |want| (tol {rel})"


def test_forward_and_features_match_flax(pair):
    """Eval mode: the decoded (B, A, [4 +] 7 + 12) output, the deepest
    backbone map beside it, and forward_features."""
    jm, v, tm, _ = pair
    x = _images()
    want, jfeats = jax.jit(lambda v, x: (jm.apply(v, x, train=False),
                                         jm.forward_features(v, x)))(v, x)
    with torch.no_grad():
        got, deepest = tm(torch.from_numpy(x), return_features=True)
        feats = tm.forward_features(torch.from_numpy(x))
    A = 8 * 8 + 4 * 4 + 2 * 2
    assert got.shape == (2, A, (4 if tm.reg_max else 0) + 7 + 12)
    _close(got.numpy(), want)
    assert len(feats) == len(jfeats)
    for a, b in zip(feats, jfeats):
        _close(a.numpy(), b)
    _close(deepest.numpy(), jfeats[-1])


def test_train_mode_maps_and_running_statistics_match_flax(pair):
    """Train mode: the raw per-scale NHWC maps, and every BatchNorm's
    running statistics after one update (flax's biased-variance rule,
    momentum 0.9 as torch's 0.1)."""
    jm, v, tm, _ = pair
    x = _images(4, seed=5)
    outs, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    tm.train()
    try:
        got = tm(torch.from_numpy(x))
    finally:
        tm.eval()
    assert len(got) == 3
    for a, b in zip(got, outs):
        _close(a.detach().numpy(), b, rel=5e-5)
    after = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    want = from_flax_dinov3_pose({"params": v["params"],
                                  "batch_stats": after})
    sd = tm.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        _close(sd[k].numpy(), want[k].numpy())
    tm.load_state_dict(from_flax_dinov3_pose(v))     # restore for others


def test_from_flax_maps_every_leaf_and_module_path(pair):
    """Every port tensor gets a value, every flax leaf is used once, and
    every conv and dense layer has its flax module path (the keys of
    JAX's PTQ scales), a path that exists in the tree."""
    jm, v, tm, paths = pair
    sd = from_flax_dinov3_pose(v)
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k, t in sd.items():
        assert t.shape == want[k].shape, k
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(v))
    assert n_flax == sum(t.numel() for k, t in sd.items()
                         if not k.endswith("num_batches_tracked"))
    layers = {n for n, m in tm.named_modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    assert set(paths) == layers
    for path in paths.values():
        node = v["params"]
        for part in path.split("/"):
            node = node[part]
        assert "kernel" in node, path


@pytest.mark.parametrize("src,dst", [((4, 4), (2, 2)), ((40, 40), (20, 20)),
                                     ((6, 10), (4, 4)), ((4, 4), (8, 8)),
                                     ((40, 40), (80, 80)), ((3, 5), (3, 5))])
def test_resize_is_jax_image_resize_bilinear(src, dst):
    """jax.image.resize's bilinear: an upsample is torch's plain bilinear,
    a shrinking side needs the antialiased one."""
    x = np.random.RandomState(0).normal(size=(2, *src, 5)).astype(np.float32)
    want = jax.image.resize(x, (2, *dst, 5), method="bilinear")
    got = resize_to(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6)


def test_anchors_dist2bbox_and_dfl_match_jax():
    shapes, strides = [(8, 6), (4, 3), (2, 2)], (8, 16, 32)
    ja, js = jhead.make_anchors(shapes, strides)
    ta, ts = thead.make_anchors(shapes, strides)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rs = np.random.RandomState(0)
    d = rs.uniform(0, 5, (2, len(ta), 4)).astype(np.float32)
    for xywh in (True, False):
        np.testing.assert_allclose(
            thead.dist2bbox(torch.from_numpy(d), ta[None], xywh).numpy(),
            np.asarray(jhead.dist2bbox(d, ja[None], xywh)), atol=1e-6)
    logits = rs.normal(size=(2, 7, 4 * 16)).astype(np.float32)
    np.testing.assert_allclose(
        thead.dfl_integral(torch.from_numpy(logits), 16).numpy(),
        np.asarray(jhead.dfl_integral(logits, 16)), rtol=1e-6)


@pytest.mark.parametrize("yaml,over", [
    ("dinov3_vitpose.yaml", {}),
    ("dinov3_pose.yaml", {"loss.name": "v8_pose"})])
def test_builder_builds_the_full_width_configs(yaml, over):
    """The Builder on the repository's DINOv3Pose yamls at full width:
    flax's parameter count (loss v8_pose turns the box branch on in both
    packages), float32 masters computing in bf16, the backbone under
    `backbone.` and frozen by the optimizer, flax's init constants (class
    bias -log(99), ViT layer scales 1e-5, ConvNeXt's 1e-6)."""
    from tpupose.configs import load_config as jload

    path = f"tpupose/configs/method/{yaml}"
    cfg, jcfg = load_config(path, over), jload(path, over)
    model = Builder(cfg, "cpu").model()
    jm = JBuilder(jcfg).model()
    H, W = cfg.data.image_size
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, H, W, 3)),
                                            train=False))
    n_flax = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    assert model.reg_max == jm.reg_max
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for br in model.head.cls:
        assert torch.all(br.out.bias == np.float32(thead.PRIOR_BIAS))
    for m in model.modules():
        if isinstance(m, LayerScale):
            assert torch.all(m.gamma == np.float32(1e-5))
        if isinstance(m, ConvNeXtBlock):
            assert torch.all(m.gamma == np.float32(1e-6))
    names = [n for n, _ in model.named_parameters()]
    bb = [n for n in names if is_backbone_path(n)]
    assert bb and len(bb) == sum(
        1 for n, _ in model.backbone.named_parameters())
    opt = Builder(cfg, "cpu").optimizer(model, 1)
    trained = {id(p) for g in opt.inner.param_groups for p in g["params"]}
    assert not trained & {id(p) for p in model.backbone.parameters()}
    assert len(trained) == sum(1 for n in names if not is_backbone_path(n))
