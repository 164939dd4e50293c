"""cli/video.py (`run_video`, `main`) held against the JAX package's
run_video on the CPU, single-stage and two-stage, and its int8 and
device behaviour. The setup and tolerances are tests/test_torch_video.py's
(see its docstring): JAX's run_video on its own states (flax's init from
PRNGKey(0) for the detector, PRNGKey(1) for stage 2, under jit), the port
on those states converted and saved as port checkpoints; conf 0.010006
with the candidate scores asserted 5e-8 apart on this seed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tpupose_torch.engine.predictor import YoloPosePredictor
from tpupose_torch.utils.convert import (from_flax_dinov3_pose,
                                         from_flax_simple_baseline)

from test_torch_video import (POSE_YAML, VIDEO_CONF, T, _assert_separated,
                              _close_pose, _jit_create_train_state)
from torch_threads import one_torch_thread  # noqa: F401

DET_YAML = ("model:\n  name: dinov3_pose\n  backbone: dinov3_convnext_atto\n"
            "  num_keypoints: 4\n  num_classes: 2\n"
            "  neck_channels: [48, 96, 192]\n"
            "data:\n  image_size: [64, 64]\n"
            "train:\n  mixed_precision: false\n"
            f"eval:\n  video_batch: 2\n  conf_threshold: {VIDEO_CONF}\n")


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """5 seeded 48x80 frames (chunks of 2, the tail repeat-padded), the
    two yamls, and JAX run_video's own states (PRNGKey(0) for the
    detector, PRNGKey(1) for stage 2) saved as port checkpoints; JAX's
    create_train_state under jit for the module (see above)."""
    from tpupose.configs import load_config as jload
    from tpupose.engine import train_state as j_train_state
    from tpupose.engine.builder import Builder as JBuilder
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import CheckpointManager
    from tpupose_torch.engine.train_state import TrainState
    from tpupose_torch.ops.preprocess import normalize_images

    mp = pytest.MonkeyPatch()
    mp.setattr(j_train_state, "create_train_state", _jit_create_train_state)
    d = tmp_path_factory.mktemp("video")
    (d / "frames").mkdir()
    rs = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rs.randint(0, 255, (48, 80, 3)).astype(np.uint8)
                        ).save(d / "frames" / f"f_{i}.png")
    (d / "pose.yaml").write_text(POSE_YAML)
    (d / "det.yaml").write_text(DET_YAML)

    def save(name, key, convert):
        jcfg = jload(str(d / f"{name}.yaml"))
        H, W = jcfg.data.image_size
        st = _jit_create_train_state(JBuilder(jcfg).model(),
                                     jax.random.PRNGKey(key),
                                     jnp.zeros((1, H, W, 3)), optax.sgd(0.0))
        v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), {
            "params": st.params, "batch_stats": st.batch_stats})
        b = Builder(load_config(str(d / f"{name}.yaml")), "cpu")
        m = b.model()
        m.load_state_dict(convert(v))
        CheckpointManager(str(d / f"{name}_ckpt")).save(
            0, TrainState(m, b.optimizer(m, 1)), force=True)
        return m

    det = save("det", 0, from_flax_dinov3_pose)
    save("pose", 1, from_flax_simple_baseline)
    # the detector's scores as run_video feeds it the frames (resized to
    # 64x64; the port's scores, within 1e-8 of JAX's): candidates well
    # apart (see above)
    frames = np.stack([np.asarray(Image.open(d / "frames" / f"f_{i}.png")
                                  .convert("RGB").resize((64, 64)), np.uint8)
                       for i in range(5)])
    with torch.no_grad():
        dec = det(normalize_images(T(frames), scale_only=True))
    _assert_separated(dec[..., :2].amax(-1), VIDEO_CONF, 5e-8)
    yield d
    mp.undo()


def _tracks(path):
    return [json.loads(s) for s in path.read_text().splitlines()]


@pytest.mark.parametrize("two_stage", [False, True],
                         ids=["single-stage", "two-stage"])
def test_run_video_matches_jax(video_dir, two_stage):
    """JAX's run_video (its states from PRNGKey(0) / PRNGKey(1)) against
    the port's `main` (the CLI's entry) on those states as checkpoints:
    the same track ids in every frame, boxes within 1e-5 of their largest
    value, keypoints as stated; one log line and one annotated frame per
    real frame (the padded tail adds none)."""
    from tpupose.cli.video import run_video as j_run_video
    from tpupose.configs import load_config as jload
    from tpupose_torch.cli.video import main

    d = video_dir
    tag = "two" if two_stage else "one"
    extra = {"pose_cfg": str(d / "pose.yaml")} if two_stage else {}
    j_run_video(jload(str(d / "det.yaml")), str(d / "frames"),
                str(d / f"j_{tag}"), **extra)
    argv = ["--cfg", str(d / "det.yaml"), "--ckpt", str(d / "det_ckpt"),
            "--device", "cpu", f"frames_dir={d / 'frames'}",
            f"output_dir={d / f't_{tag}'}"]
    if two_stage:
        argv += [f"pose_cfg={d / 'pose.yaml'}",
                 f"pose_ckpt={d / 'pose_ckpt'}"]
    assert main(argv) == 0
    want = _tracks(d / f"j_{tag}" / "tracks.jsonl")
    got = _tracks(d / f"t_{tag}" / "tracks.jsonl")
    assert [r["frame"] for r in got] == list(range(5))
    assert [r["file"] for r in got] == [r["file"] for r in want]
    n_kpts = 6 if two_stage else 4
    for a, b in zip(got, want):
        assert [t["id"] for t in a["tracks"]] == [t["id"] for t in b["tracks"]]
        assert a["tracks"]
        ba = np.array([t["box"] for t in a["tracks"]])
        bb = np.array([t["box"] for t in b["tracks"]])
        np.testing.assert_allclose(ba, bb, atol=1e-5 * np.abs(bb).max())
        ka = np.array([t["keypoints"] for t in a["tracks"]])
        kb = np.array([t["keypoints"] for t in b["tracks"]])
        assert ka.shape[1:] == (n_kpts, 3)
        if two_stage:
            _close_pose(ka, kb)
        else:
            np.testing.assert_allclose(ka, kb, atol=1e-5 * np.abs(kb).max())
    for r in got:
        assert (d / f"t_{tag}" / r["file"]).exists()


def test_run_video_int8_two_stage_runs(video_dir):
    """eval.int8 on both stages (the detector calibrated on the first
    frame, stage 2 on its person crops): a track line per frame, the
    stage-2 keypoints."""
    from tpupose_torch.cli.video import run_video
    from tpupose_torch.configs import load_config

    d = video_dir
    cfg = load_config(str(d / "det.yaml"), {"eval.int8": "true"})
    stats = run_video(cfg, str(d / "frames"), str(d / "t_int8"),
                      str(d / "det_ckpt"), pose_cfg=str(d / "pose.yaml"),
                      pose_ckpt=str(d / "pose_ckpt"), device="cpu")
    assert stats["frames"] == 5 and stats["seconds"] > 0
    lines = _tracks(d / "t_int8" / "tracks.jsonl")
    assert len(lines) == 5
    assert all(len(t["keypoints"]) == 6 for r in lines for t in r["tracks"])


def test_run_video_defaults_to_cuda(video_dir, monkeypatch):
    """Without device="cpu" the pipeline asks for CUDA and raises where
    there is none, before it reads a frame."""
    from tpupose_torch.cli.video import main, run_video
    from tpupose_torch.configs import load_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_video(load_config(str(video_dir / "det.yaml")),
                  str(video_dir / "frames"), str(video_dir / "t_none"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--cfg", str(video_dir / "det.yaml"),
              f"frames_dir={video_dir / 'frames'}",
              f"output_dir={video_dir / 't_none'}"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloPosePredictor(torch.nn.Linear(1, 1), 7, 4)
