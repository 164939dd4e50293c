"""tpupose_torch models, weight transfer, the plain versions of the three
fused ResNet kernels, and the whole uint8 -> source-coords slice, each
held against the JAX package on the CPU in float32 (flax models built
with dtype=float32). Weights come from a flax init with non-trivial
BatchNorm statistics and are carried across with
`from_flax_simple_baseline`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.train_state import TrainState
from tpupose.models.backbones.resnet import Bottleneck as JBottleneck
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose.ops.pallas_layer1 import fold_layer1_weights as j_fold_layer1
from tpupose.ops.pallas_layer1 import layer1_reference as j_layer1
from tpupose.ops.pallas_stem import stem_reference as j_stem
from tpupose.ops.preprocess import normalize_images as j_normalize
from tpupose.utils.convert import convert_resnet
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.ops.cuda_bridge import bridge, fold_bridge_weights
from tpupose_torch.ops.cuda_layer1 import fold_layer1_weights, layer1
from tpupose_torch.ops.cuda_stem import fold_stem_weights, stem_pool
from tpupose_torch.ops.preprocess import normalize_images
from tpupose_torch.utils.convert import from_flax_simple_baseline
from torch_threads import one_torch_thread  # noqa: F401


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _randomize_bn(tree, rs):
    """Non-trivial BN scale/bias/mean/var everywhere in a flax tree."""
    def walk(p, s):
        for k in p:
            if k.startswith("BatchNorm"):
                n = p[k]["scale"].shape
                p[k]["scale"] = rs.uniform(0.5, 1.0, n).astype(np.float32)
                p[k]["bias"] = rs.normal(0, 0.1, n).astype(np.float32)
                s[k]["mean"] = rs.normal(0, 0.3, n).astype(np.float32)
                s[k]["var"] = rs.uniform(0.5, 2.0, n).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    walk(tree["params"], tree["batch_stats"])
    return tree


def _flax_pair(backbone, deconv=(32, 32, 32), seed=0):
    jm = JSimpleBaseline(backbone=backbone, num_keypoints=17,
                         deconv_channels=deconv, dtype=jnp.float32)
    # parameter shapes do not depend on the input size: init small
    v = jm.init(jax.random.PRNGKey(seed),
                jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(seed + 1))
    tm = SimpleBaseline(backbone, 17, deconv, dtype=torch.float32,
                        device="cpu")
    tm.load_state_dict(from_flax_simple_baseline(v))
    return jm, v, tm


@pytest.fixture(scope="module")
def r50():
    return _flax_pair("resnet50")


@pytest.fixture(scope="module")
def r18():
    return _flax_pair("resnet18")


def test_weight_transfer_resnet18(r18):
    jm, v, tm = r18
    x = np.random.RandomState(2).uniform(-2, 2, (2, 64, 64, 3)) \
        .astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 16, 17)
    assert _rel(got, want) < 1e-4


def test_backbone_round_trip_through_convert_resnet(r18):
    """The port keeps torchvision names: its backbone state dict maps back
    onto the original flax tree through tpupose.utils.convert."""
    _, v, tm = r18
    sd = {k[len("backbone."):]: t for k, t in tm.state_dict().items()
          if k.startswith("backbone.")}
    back = convert_resnet(sd, (2, 2, 2, 2), bottleneck=False)
    want = jax.tree_util.tree_leaves_with_path(
        {"params": v["params"]["ResNet_0"],
         "batch_stats": v["batch_stats"]["ResNet_0"]})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_stem_plain_version(r50):
    _, v, tm = r50
    x = np.random.RandomState(3).uniform(-2, 2, (2, 256, 192, 3)) \
        .astype(np.float32)
    want = j_stem(v, jnp.asarray(x), dtype=jnp.float32)
    got = stem_pool(torch.from_numpy(x),
                    fold_stem_weights(tm.backbone, torch.float32))
    assert got.shape == (2, 64, 48, 64)
    assert _rel(got.numpy(), want) < 1e-4


def test_layer1_plain_version(r50):
    _, v, tm = r50
    x = np.random.RandomState(4).uniform(0, 2, (2, 64, 48, 64)) \
        .astype(np.float32)
    want = j_layer1(jnp.asarray(x), j_fold_layer1(v, dtype=jnp.float32))
    got = layer1(torch.from_numpy(x),
                 fold_layer1_weights(tm.backbone, torch.float32))
    assert got.shape == (2, 64, 48, 256)
    assert _rel(got.numpy(), want) < 1e-4


def test_bridge_plain_version(r50):
    """block2_0 vs the flax Bottleneck_3 applied alone in float32 (the
    JAX bridge_reference rounds to bf16, so it is no float32 oracle)."""
    _, v, tm = r50
    x = np.random.RandomState(5).uniform(0, 2, (2, 64, 48, 256)) \
        .astype(np.float32)
    blk = {"params": v["params"]["ResNet_0"]["Bottleneck_3"],
           "batch_stats": v["batch_stats"]["ResNet_0"]["Bottleneck_3"]}
    want = JBottleneck(filters=128, strides=2, dtype=jnp.float32).apply(
        blk, jnp.asarray(x), train=False)
    got = bridge(torch.from_numpy(x),
                 fold_bridge_weights(tm.backbone, torch.float32))
    assert got.shape == (2, 32, 24, 512)
    assert _rel(got.numpy(), want) < 1e-4


def _slice(model_triple, hw, hm_size, seed):
    jm, v, tm = model_triple
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (1, *hw, 3)).astype(np.uint8)
    centers = rs.uniform(80, 120, (1, 2)).astype(np.float32)
    scales = rs.uniform(150, 250, (1, 2)).astype(np.float32)

    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=(),
                       apply_fn=jm.apply, tx=optax.sgd(0.0))
    jev = JEvaluator(state, hm_size, decode="dark", flip_test=True)
    want_c, want_s = jev._step(state, jnp.asarray(imgs), jnp.asarray(centers),
                               jnp.asarray(scales))
    want_hm = jm.apply(v, j_normalize(jnp.asarray(imgs)), train=False)

    ev = TopDownEvaluator(tm, hm_size, decode="dark", flip_test=True,
                          device="cpu")
    got_c, got_s = ev.step(imgs, centers, scales)
    got_hm = ev.forward(normalize_images(torch.from_numpy(imgs)))
    assert _rel(got_hm.numpy(), want_hm) < 1e-3
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-3, atol=1e-3 * np.abs(want_s).max())
    # 1e-2 px in heatmap space; back-projection scales by scale/heatmap
    px = float(np.max(scales[0] / np.array(hm_size[::-1])))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=1e-2 * px)
    return ev


def test_slice_r50_fused_route(r50):
    """uint8 -> source coords through the port's evaluator, which takes
    the fused-kernel forward (plain versions on the CPU) for R50 at
    256x192, vs tpupose's TopDownEvaluator._eval_step."""
    ev = _slice(r50, (256, 192), (64, 48), seed=6)
    assert ev.fast_weights is not None


def test_slice_r18_plain_route(r18):
    ev = _slice(r18, (64, 64), (16, 16), seed=7)
    assert ev.fast_weights is None
