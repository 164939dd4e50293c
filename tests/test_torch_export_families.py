"""The port's exported programs of the SimCC, bottom-up and yolo families
(tpupose_torch/engine/exporter.py) against their eager steps and the JAX package's `export_stablehlo`
programs on the converted weights (tests/test_predictor_exporter_
tracker.py's recipes; the heatmap family, the ops and npz are in
tests/test_torch_export.py, the CLI in tests/test_torch_export_cli.py).

Tolerances: a loaded program equals the port's eager step bit for bit,
except SimCC's scores, within 1e-6 relative, and the yolo program's
detections (classes and valid equal, boxes, scores and keypoints within
1e-5 of each one's largest): the ATen-level graph decomposes a few float32
ops (a softmax reduction, the ViT's norms) in another order; against JAX: SimCC coordinates within 1e-3
source px and scores 1e-4, bottom-up people equal (mask) with coordinates
within 1e-3 px, detections at tests/test_torch_video.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.exporter import export_stablehlo, load_stablehlo
from tpupose.engine.predictor import BottomUpPredictor as JBottomUpPredictor
from tpupose.engine.predictor import YoloPosePredictor as JYolo
from tpupose.models.simcc import SimCCPose as JSimCC
from tpupose_torch.engine import exporter
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.engine.predictor import (BottomUpPredictor,
                                            YoloPosePredictor)
from tpupose_torch.models.simcc import SimCCPose
from tpupose_torch.utils.convert import from_flax_simcc

from test_torch_bottom_up import _flax_bottom_up, _port_bottom_up
from test_torch_dinov3 import flax_dinov3, port_dinov3
from test_torch_evaluate import _jstate, _randomize_bn
from test_torch_export import HW, K, T, _crops
from test_torch_video import (_check_detections, _frames, _jax_state,
                              _spread_scores)
from torch_threads import one_torch_thread  # noqa: F401


def _round_trip(tmp_path, module, args):
    path = exporter.export_program(module, args, str(tmp_path / "prog.pt2"))
    return exporter.load_program(path)


def _jax_program(tmp_path, fn, args):
    path = export_stablehlo(fn, args, str(tmp_path / "prog.stablehlo"))
    return load_stablehlo(path)


def test_simcc_program_matches_eager_and_jax(tmp_path):
    """The SimCC program (1D bins, flip-averaged probabilities, argmax +
    parabolic refinement)."""
    jm = JSimCC(backbone="resnet18", num_keypoints=K, split_ratio=1.0,
                dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(5), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(6))
    tm = SimCCPose("resnet18", K, 1.0, HW, dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_simcc(v))
    pairs = np.array([(1, 2)])
    ev = TopDownEvaluator(tm, HW, flip_test=True, flip_pairs=pairs,
                          family="simcc", device="cpu")
    imgs, c, s = _crops(seed=1)
    prog = _round_trip(tmp_path, exporter.HeatmapProgram(ev),
                       (T(imgs), T(c), T(s)))
    got = prog(T(imgs), T(c), T(s))
    eager = ev.step(imgs, c, s)
    assert torch.equal(got[0], eager[0])
    torch.testing.assert_close(got[1], eager[1], rtol=1e-6, atol=0)
    jev = JEvaluator(_jstate(jm.apply, v), HW, flip_test=True,
                     flip_pairs=pairs, family="simcc")
    call = _jax_program(tmp_path, lambda i, cc, ss: jev._simcc_eval_step(
        jev.state, i, cc, ss), (imgs, c, s))
    wc, ws = call(imgs, c, s)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wc), atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-6)


def test_bottom_up_program_matches_eager_and_jax(tmp_path):
    """The bottom-up program (forward, flip-averaged heatmaps, AE
    grouping, stride back to input px)."""
    jm, v = _flax_bottom_up("resnet18", seed=3)
    tm = _port_bottom_up("resnet18", v)
    pairs = np.array([(1, 2)])
    kw = dict(max_people=5, flip_test=True, flip_pairs=pairs)
    pred = BottomUpPredictor(tm, device="cpu", **kw)
    imgs = _crops(seed=2)[0]
    prog = _round_trip(tmp_path, exporter.BottomUpProgram(pred), (T(imgs),))
    got = dict(zip(exporter.BottomUpProgram.KEYS, prog(T(imgs))))
    eager = pred.dispatch(imgs)
    for k, g in got.items():
        assert torch.equal(g, eager[k]), k
    jp = JBottomUpPredictor(_jstate(jm.apply, v), **kw)
    call = _jax_program(tmp_path, lambda i: jp._step(jp.state, i), (imgs,))
    want = call(imgs)
    np.testing.assert_array_equal(got["person_mask"].numpy(),
                                  np.asarray(want["person_mask"]))
    np.testing.assert_allclose(got["coords"].numpy(),
                               np.asarray(want["coords"]), atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-4,
                               atol=1e-6)


def test_yolo_program_matches_eager_and_jax(tmp_path):
    """DINOv3Pose (ConvNeXt atto, 64x64, the box-free head of
    dinov3_vitpose.yaml's pose_compute): the program of decode + NMS (its
    loop unrolled)."""
    jm, v = flax_dinov3("dinov3_convnext_atto", 0, seed=4)
    v = _spread_scores(v, 10.0)
    tm = port_dinov3("dinov3_convnext_atto", 0, v)
    kw = dict(num_classes=7, num_keypoints=4, conf_threshold=0.1,
              has_box_branch=False, max_detections=12)
    pred = YoloPosePredictor(tm, device="cpu", **kw)
    frames = _frames(2)
    prog = _round_trip(tmp_path, exporter.YoloProgram(pred), (T(frames),))
    names = ("boxes", "scores", "classes", "keypoints", "valid")
    got = {k: g.numpy() for k, g in zip(names, prog(T(frames)))}
    eager = {k: g.numpy() for k, g in zip(names, pred._infer(T(frames)))}
    assert got["valid"].any()
    _check_detections(got, eager)
    jp = JYolo(_jax_state(jm, v), **kw)
    call = _jax_program(tmp_path, lambda f: jp._infer(jp.state, f),
                        (frames,))
    want = dict(zip(names, (np.asarray(a) for a in call(frames))))
    _check_detections(got, want)
