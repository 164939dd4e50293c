"""The port's multi-person video pipeline held against the JAX package on
the CPU: ops/nms.py, ops/roi.py, YoloPosePredictor, engine/two_stage.py
and engine/tracker.py here, cli/video.py in tests/test_torch_video_cli.py
(the file's helpers and tolerances are shared).

Models are small: DINOv3Pose on ConvNeXt "atto" with neck (48, 96, 192)
at 64x64 (84 anchors) and, for stage 2, a SimpleBaseline-R18 (deconvs of
32) at 64x64, float32; flax's init from the same keys on both sides,
carried across by the converters (with non-trivial BatchNorm statistics
where a test makes its own weights). Inputs from numpy seeds.

Tolerances, with their reasons:
  - NMS keep masks, classes, valid flags, track ids: equal. JAX's NMS is
    called eagerly here (jitted, XLA may contract the IoU's products into
    FMAs; the pipelines' own comparisons below hold jitted JAX);
  - IoU and ROI embeddings: 1e-6 absolute, 1e-5 of the largest value
    (float32 sums in another order);
  - detections (boxes, scores, keypoints, embeddings): 1e-5 of the
    largest |value| (the decoded outputs' float32 readings are 1e-7 of
    it); embeddings are bf16 on both sides, so 1 bf16 ulp (2^-8 of a
    value) where a value sits on a rounding boundary;
  - stage 2 and the two-stage run_video: keypoints within 1e-3 px and
    scores within 1e-4 (JAX's jitted warp is contracted into FMAs, the
    port's crops are the eager oracle's: ROADMAP Queue C);
  - the int8 intercept: the decoded output within 2e-2 of its largest
    |value|, 2e-3 on average (a float32 activation at a rounding
    boundary moves one int8 count now and then, as in
    tests/test_torch_quant.py).

Near-equal scores: the two sides' scores differ by up to ~1e-8 (a few
float32 ulps at 0.01), and two candidates closer than that could be
ranked in either order. `_assert_separated` asserts, on this file's
seeds, that the candidate scores (>= conf) lie at least a stated gap
apart and as far from the threshold, before the order-sensitive
comparisons:
  - the predictor tests spread the scores as a trained head would (the
    class convs' kernels x10, x20 with the box branch, in the flax tree:
    12-20 candidates a frame above conf 0.25, their scores up to 0.94
    and 3e-7 apart between the two sides): gap 1e-5;
  - run_video runs JAX's own states (flax's init from PRNGKey(0), every
    score within 3e-5 of 0.01 and many within 1e-8 of another): conf
    0.010006 keeps the top 1-4 candidates of a frame, gap 5e-8.
JAX's run_video builds its states with an eager `model.init` (a minute
of op-by-op compiles on the CPU); the tests swap `create_train_state`
for the same init under jit (same key, same draws) on both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.engine.predictor import YoloPosePredictor as JYolo
from tpupose.engine.two_stage import TwoStagePosePredictor as JTwoStage
from tpupose.engine.two_stage import \
    boxes_to_center_scale as j_boxes_to_center_scale
from tpupose.engine.tracker import PoseTracker as JTracker
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose.ops import roi as j_roi
from tpupose_torch.engine.predictor import YoloPosePredictor
from tpupose_torch.engine.tracker import PoseTracker
from tpupose_torch.engine.two_stage import (TwoStagePosePredictor,
                                            boxes_to_center_scale,
                                            person_crops)
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.ops import nms as t_nms
from tpupose_torch.ops import roi as t_roi
from tpupose_torch.utils.convert import from_flax_simple_baseline

from test_torch_dinov3 import flax_dinov3, port_dinov3
from test_torch_model import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401

j_nms = importlib.import_module("tpupose.ops.nms")
T = torch.from_numpy
CONF = 0.25
VIDEO_CONF = 0.010006
POSE_YAML = ("model:\n  name: simple_baseline\n  backbone: resnet18\n"
             "  num_keypoints: 6\n  heatmap_size: [16, 16]\n"
             "  deconv_channels: [32, 32, 32]\n"
             "data:\n  image_size: [64, 64]\n"
             "train:\n  mixed_precision: false\n")


def _boxes(rs, shape, lo=0.0, hi=600.0):
    xy = rs.uniform(lo, hi, (*shape, 2))
    wh = rs.uniform(5, 120, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _assert_separated(scores, conf, gap):
    """Every two candidate scores (>= conf) of an image lie at least `gap`
    apart, and every score at least `gap` from conf, so rounding can
    neither reorder candidates nor move one across the threshold."""
    for s in np.asarray(scores, np.float64).reshape(len(scores), -1):
        c = np.sort(s[s >= conf])
        assert len(c) >= 1
        assert len(c) < 2 or np.diff(c).min() >= gap, np.diff(c).min()
        assert np.abs(s - conf).min() >= gap, np.abs(s - conf).min()


def _jit_create_train_state(model, rng, sample_input, tx, train=False,
                            ema_decay=0.0):
    """tpupose's create_train_state with model.init under jit."""
    from tpupose.engine.train_state import TrainState as JTrainState

    v = jax.jit(model.init, static_argnames="train")(rng, sample_input,
                                                     train=train)
    return JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v.get("batch_stats", {}),
                       opt_state=tx.init(v["params"]), apply_fn=model.apply,
                       tx=tx, ema_params=None, ema_decay=float(ema_decay))


# -- NMS ----------------------------------------------------------------------


def test_box_iou_matches_jax():
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, (40,)), _boxes(rs, (30,))
    a[:3, 2:] = a[:3, :2]                       # degenerate boxes
    np.testing.assert_allclose(
        t_nms.box_iou(T(a), T(b)).numpy(),
        np.asarray(j_nms.box_iou(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


@pytest.mark.parametrize("n", [50, 600])
def test_nms_keep_mask_equals_jax(n):
    """Batched over 3 images; scores rounded to 1/20 so many tie (the
    stable order puts the lower index first, as jnp.argsort); a valid
    mask; n = 600 runs past the 512 of the pose preselect."""
    rs = np.random.RandomState(n)
    boxes = _boxes(rs, (3, n))
    scores = (np.round(rs.uniform(0, 1, (3, n)) * 20) / 20).astype(
        np.float32)
    valid = rs.uniform(size=(3, n)) > 0.2
    got = t_nms.nms(T(boxes), T(scores), 0.45, valid=T(valid)).numpy()
    for b in range(3):
        want = j_nms.nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.45,
                         valid=jnp.asarray(valid[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))
    one = t_nms.nms(T(boxes[0]), T(scores[0]), 0.45, valid=T(valid[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


@pytest.mark.parametrize("n", [84, 8400])
def test_batched_pose_nms_equals_jax(n):
    """The pose NMS per image: class offsets, the conf threshold, max_det
    100 and (n = 8400, the anchors of a 640x640 input) the top-512
    preselect with tied scores, whose order lax.top_k and the stable
    descending sort agree on."""
    rs = np.random.RandomState(n)
    boxes = _boxes(rs, (2, n))
    scores = (np.round(rs.uniform(0, 1, (2, n)) * 50) / 50).astype(
        np.float32)
    classes = rs.randint(0, 3, (2, n)).astype(np.int32)
    kpts = rs.uniform(0, 640, (2, n, 4, 3)).astype(np.float32)
    got = t_nms.batched_pose_nms(T(boxes), T(scores), T(classes), T(kpts),
                                 0.45, 0.3, 100)
    want = jax.vmap(lambda b, s, c, k: j_nms.batched_pose_nms(
        b, s, c, k, 0.45, 0.3, 100))(boxes, scores, classes, kpts)
    assert got[-1].numpy().sum() > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- ROI pooling --------------------------------------------------------------


def test_roi_mean_pool_matches_jax():
    """Boxes inside, across the border, degenerate and all zero (padded
    slots) on a stride-16 map."""
    rs = np.random.RandomState(1)
    fmap = rs.normal(size=(2, 4, 5, 8)).astype(np.float32)
    boxes = _boxes(rs, (2, 6), -20.0, 70.0)
    boxes[0, 1] = [10, 10, 10, 10]
    boxes[1, 2] = 0.0
    for l2 in (True, False):
        want = np.asarray(j_roi.roi_mean_pool(jnp.asarray(fmap),
                                              jnp.asarray(boxes), (64, 80),
                                              l2_normalize=l2))
        got = t_roi.roi_mean_pool(T(fmap), T(boxes), (64, 80),
                                  l2_normalize=l2).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-6,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        t_roi.integral_image(T(fmap)).numpy(),
        np.asarray(j_roi.integral_image(jnp.asarray(fmap))), atol=1e-5)


# -- YoloPosePredictor --------------------------------------------------------


def _jax_state(jm, v):
    from tpupose.engine.train_state import TrainState as JTrainState

    tx = optax.sgd(0.0)
    return JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]), apply_fn=jm.apply,
                       tx=tx)


def _spread_scores(v, factor):
    """The class convs' kernels x`factor`: scores across (0, 1)."""
    head = v["params"]["PoseHead_0"]
    for k, br in head.items():
        if k.startswith("_ClsBranch_"):
            br["Conv_0"]["kernel"] = br["Conv_0"]["kernel"] * np.float32(
                factor)
    return v


@pytest.fixture(scope="module")
def detectors():
    """{reg_max: (flax state, port model, {port name: flax path})}."""
    out = {}
    for reg_max in (0, 16):
        jm, v = flax_dinov3("dinov3_convnext_atto", reg_max, seed=4)
        v = _spread_scores(v, 20.0 if reg_max else 10.0)
        paths = {}
        tm = port_dinov3("dinov3_convnext_atto", reg_max, v, paths)
        out[reg_max] = (_jax_state(jm, v), tm, paths)
    return out


def _frames(n=3, hw=(64, 64), seed=7):
    return np.random.RandomState(seed).randint(
        0, 256, (n, *hw, 3)).astype(np.uint8)


def _check_detections(got, want, conf_scores=None):
    assert set(got) == set(want)
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("boxes", "scores", "keypoints"):
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12))
    if "features" in want:
        w = np.asarray(want["features"], np.float32)
        np.testing.assert_allclose(got["features"], w, rtol=2 ** -8,
                                   atol=1e-6)


@pytest.mark.parametrize("reg_max,appearance", [(0, True), (0, False),
                                                (16, True)])
def test_yolo_predictor_matches_jax(detectors, reg_max, appearance):
    """Box-free and box-branch heads, with and without appearance
    embeddings: JAX's jitted predictor against the port's."""
    state, tm, _ = detectors[reg_max]
    kw = dict(num_classes=7, num_keypoints=4, conf_threshold=CONF,
              has_box_branch=reg_max > 0, appearance=appearance)
    frames = _frames()
    jp = JYolo(state, **kw)
    tp = YoloPosePredictor(tm, device="cpu", **kw)
    with torch.no_grad():
        dec = tm(T(frames).float() / 255.0)
    _assert_separated(dec[..., (4 if reg_max else 0):][..., :7].amax(-1),
                      CONF, 1e-5)
    want = jp(frames)
    got = tp(frames)
    assert got["valid"].any()
    _check_detections(got, want)
    assert got["boxes"].shape == (3, 84, 4)
    if appearance:
        assert got["features"].shape == (3, 84, 320)


def test_yolo_predictor_int8_matches_jax(detectors):
    """calibrate_int8 on one frame batch (the maxima of the same
    activations: 1e-5 relative), then the quantized forward with JAX's
    scales, mapped to the port's modules by the converter's paths: the
    decoded output within the int8 tolerance."""
    from tpupose.ops.quant import quantized_apply as j_qapply
    from tpupose.ops.preprocess import normalize_images as j_norm
    from tpupose_torch.ops.preprocess import normalize_images
    from tpupose_torch.ops.quant import quantized_apply

    state, tm, paths = detectors[0]
    frames = _frames(2, seed=9)
    jscales = JYolo.calibrate_int8(state, frames)
    tscales = YoloPosePredictor.calibrate_int8(tm, frames)
    back = {v: k for k, v in paths.items()}
    assert set(jscales) == {paths[k] for k in tscales}
    for k, v in tscales.items():
        assert abs(v - jscales[paths[k]]) <= 1e-5 * abs(jscales[paths[k]])
    mapped = {back[k]: v for k, v in jscales.items()}
    x = j_norm(jnp.asarray(frames), scale_only=True)
    want = np.asarray(jax.jit(lambda v, x: j_qapply(
        state.apply_fn, v, jscales, x, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, x))
    got = quantized_apply(tm, mapped, normalize_images(
        T(frames), scale_only=True)).numpy()
    den = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * den
    assert np.abs(got - want).mean() <= 2e-3 * den
    out = YoloPosePredictor(tm, 7, 4, conf_threshold=CONF, device="cpu",
                            quant_scales=mapped, appearance=True)(frames)
    assert out["valid"].any() and np.isfinite(out["features"]).all()


# -- two-stage ----------------------------------------------------------------


def test_boxes_to_center_scale_and_person_crops_match_jax():
    from tpupose.engine.two_stage import person_crops as j_person_crops

    rs = np.random.RandomState(2)
    boxes = _boxes(rs, (2, 3), 0.0, 60.0)
    for aspect in (0.75, 1.0, 1.6):
        c, s = boxes_to_center_scale(T(boxes), aspect)
        jc, js = j_boxes_to_center_scale(jnp.asarray(boxes), aspect)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    frames = _frames(2, (96, 80))
    valid = np.array([[1, 0, 1], [0, 0, 1]], bool)
    crops, c, s = person_crops(T(frames), T(boxes), T(valid), (32, 24))
    jcrops, jc, js = j_person_crops(jnp.asarray(frames), jnp.asarray(boxes),
                                    jnp.asarray(valid), (32, 24))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert crops.shape == (6, 32, 24, 3) and crops.dtype == torch.float32
    # the XLA warp is jitted inside JAX's crops: within 1e-2 of a pixel
    np.testing.assert_allclose(crops.numpy(), np.asarray(jcrops), atol=1e-2)


@pytest.fixture(scope="module")
def pose_pair():
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=4,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    st = _jit_create_train_state(jm, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3)), optax.sgd(0.0))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), {
        "params": st.params, "batch_stats": st.batch_stats})
    v = _randomize_bn(v, np.random.RandomState(3))
    st = st.replace(params=v["params"], batch_stats=v["batch_stats"])
    tm = SimpleBaseline("resnet18", 4, (32, 32, 32), dtype=torch.float32,
                        device="cpu")
    tm.load_state_dict(from_flax_simple_baseline(v))
    return st, tm


def _close_pose(got, want):
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-3)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], atol=1e-4)


def test_pose_from_boxes_matches_jax(pose_pair):
    st, tm = pose_pair
    frames = _frames(2, (96, 96), seed=0)
    boxes = np.array([[[10, 10, 50, 70], [30, 20, 80, 90], [0, 0, 0, 0]],
                      [[5, 5, 60, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                     np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], bool)
    kw = dict(crop_size=(64, 64), heatmap_size=(16, 16), max_persons=3)
    jc, js = JTwoStage(st, **kw).pose_from_boxes(frames, boxes, valid)
    tc, ts = TwoStagePosePredictor(tm, device="cpu", **kw).pose_from_boxes(
        frames, boxes, valid)
    assert tc.shape == (2, 3, 4, 2) and ts.shape == (2, 3, 4)
    _close_pose(np.concatenate([tc, ts[..., None]], -1),
                np.concatenate([jc, js[..., None]], -1))


def test_two_stage_with_a_detector_matches_jax(pose_pair, detectors):
    """__call__ with a YoloPosePredictor attached (the stages chained on
    the device) and with a plain callable detector (a host round trip)."""
    st, tm = pose_pair
    jstate, tdet, _ = detectors[0]
    kw = dict(num_classes=7, num_keypoints=4, conf_threshold=CONF,
              appearance=True)
    frames = _frames(2)
    tw = dict(crop_size=(64, 64), heatmap_size=(16, 16), max_persons=4)
    want = JTwoStage(st, detector=JYolo(jstate, **kw), **tw)(frames)
    tyolo = YoloPosePredictor(tdet, device="cpu", **kw)
    got = TwoStagePosePredictor(tm, detector=tyolo, device="cpu",
                                **tw)(frames)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("boxes", "det_scores"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    np.testing.assert_allclose(got["features"],
                               np.asarray(want["features"], np.float32),
                               rtol=2 ** -8, atol=1e-6)
    _close_pose(got["keypoints"], want["keypoints"])

    class Callable:
        def __call__(self, f):
            return tyolo(f)

    host = TwoStagePosePredictor(tm, detector=Callable(), device="cpu",
                                 **tw)(frames)
    np.testing.assert_allclose(host["keypoints"], got["keypoints"],
                               atol=1e-6)
    with pytest.raises(ValueError, match="no detector"):
        TwoStagePosePredictor(tm, device="cpu", **tw)(frames)


# -- tracker ------------------------------------------------------------------


def test_pose_tracker_matches_jax():
    """A seeded sequence: people that move and drift in appearance, one
    leaving, one arriving, a frame without detections, clutter."""
    rs = np.random.RandomState(0)
    ppl = [(_boxes(rs, ())[None], rs.normal(size=(1, 16)))
           for _ in range(5)]
    jt, tt = JTracker(max_age=3), PoseTracker(max_age=3)
    for f in range(12):
        here = [p for i, p in enumerate(ppl)
                if not (i == 0 and f > 6) and not (i == 4 and f < 4)]
        if f == 5:
            here = []
        boxes = np.concatenate([b + rs.normal(0, 4, b.shape) + 3 * f
                                for b, _ in here]
                               + [_boxes(rs, (1,))]).astype(np.float32)
        feats = np.concatenate([e + rs.normal(0, 0.3, e.shape)
                                for _, e in here]
                               + [rs.normal(size=(1, 16))]).astype(
                                   np.float32)
        kpts = rs.uniform(0, 640, (len(boxes), 4, 3)).astype(np.float32)
        a = jt.update(boxes, feats, kpts)
        b = tt.update(boxes, feats, kpts)
        assert [t[0] for t in a] == [t[0] for t in b]
        for (_, ba, ka), (_, bb, kb) in zip(a, b):
            np.testing.assert_array_equal(ba, bb)
            np.testing.assert_array_equal(ka, kb)
    assert jt._next_id == tt._next_id > 6
