"""cli/test.py (`run_inference`, `main`) held against the JAX package's
run_inference on the CPU: the single-stage (DINOv3Pose) branch and the
bottom-up branch, on JAX's own states (flax's init from PRNGKey(0), under
jit) carried into port checkpoints, loaded through restore_path with
"@best". What each draws (keypoints, scores, valid masks, recorded by
wrapping draw_detections in both packages) and the files each writes
are compared. Tolerances: the detector's keypoints within 1e-5 of their
largest value, with its candidate scores asserted 5e-8 apart around the
threshold (tests/test_torch_video.py's setup); the bottom-up persons'
coordinates within 1e-4 px and scores within 1e-4
(tests/test_torch_bottom_up.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tpupose_torch.utils.convert import (from_flax_bottom_up,
                                         from_flax_dinov3_pose)

from test_torch_video import VIDEO_CONF, T, _assert_separated, \
    _jit_create_train_state
from torch_threads import one_torch_thread  # noqa: F401

DET_YAML = ("model:\n  name: dinov3_pose\n  backbone: dinov3_convnext_atto\n"
            "  num_keypoints: 4\n  num_classes: 2\n"
            "  neck_channels: [48, 96, 192]\n"
            "data:\n  image_size: [64, 64]\n"
            "train:\n  mixed_precision: false\n"
            f"eval:\n  conf_threshold: {VIDEO_CONF}\n")
BU_YAML = ("model:\n  name: bottom_up\n  backbone: resnet18\n"
           "  num_keypoints: 4\n  heatmap_size: [16, 16]\n"
           "  deconv_channels: [32, 32, 32]\n"
           "data:\n  image_size: [64, 64]\n  max_instances: 6\n"
           "train:\n  mixed_precision: false\n"
           "loss:\n  name: ae\n")


@pytest.fixture(scope="module")
def infer_dir(tmp_path_factory):
    """5 seeded 48x80 images (tests/test_torch_video_cli.py's frames),
    the two yamls, and JAX run_inference's own states saved as port
    checkpoints in their best slots."""
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
    d = tmp_path_factory.mktemp("infer")
    (d / "images").mkdir()
    rs = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rs.randint(0, 255, (48, 80, 3)).astype(np.uint8)
                        ).save(d / "images" / f"f_{i}.png")
    (d / "det.yaml").write_text(DET_YAML)
    (d / "bu.yaml").write_text(BU_YAML)

    def save(name, convert):
        jcfg = jload(str(d / f"{name}.yaml"))
        st = _jit_create_train_state(JBuilder(jcfg).model(),
                                     jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3)),
                                     optax.sgd(0.0))
        v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), {
            "params": st.params, "batch_stats": st.batch_stats})
        b = Builder(load_config(str(d / f"{name}.yaml")), "cpu")
        m = b.model()
        m.load_state_dict(convert(v))
        CheckpointManager(str(d / f"{name}_ckpt")).save(
            0, TrainState(m, b.optimizer(m, 1)), metric=1.0)
        return m

    det = save("det", from_flax_dinov3_pose)
    save("bu", from_flax_bottom_up)
    frames = np.stack([np.asarray(Image.open(d / "images" / f"f_{i}.png")
                                  .convert("RGB").resize((64, 64)), np.uint8)
                       for i in range(5)])
    with torch.no_grad():
        dec = det(normalize_images(T(frames), scale_only=True))
    _assert_separated(dec[..., :2].amax(-1), VIDEO_CONF, 5e-8)
    yield d
    mp.undo()


def _recording(monkeypatch, module):
    """Wrap `module.draw_detections`: every call's (keypoints, scores,
    valid) is appended to the returned list."""
    calls = []
    real = module.draw_detections

    def draw(image, keypoints, scores, valid, **kw):
        calls.append((np.array(keypoints), np.array(scores),
                      np.array(valid, bool)))
        return real(image, keypoints, scores, valid, **kw)

    monkeypatch.setattr(module, "draw_detections", draw)
    return calls


@pytest.mark.parametrize("branch", ["yolo", "bottom_up"])
def test_run_inference_matches_jax(infer_dir, branch, monkeypatch):
    """JAX's run_inference on its PRNGKey(0) state against the port's
    `main` on that state as a checkpoint (`--ckpt dir@best`): the same
    instances drawn on every image, their keypoints and scores as the
    module docstring says, and the same files written."""
    import tpupose.cli.test as jcli
    import tpupose_torch.cli.test as pcli
    from tpupose.configs import load_config as jload

    d = infer_dir
    name = "det" if branch == "yolo" else "bu"
    jcalls = _recording(monkeypatch, jcli)
    pcalls = _recording(monkeypatch, pcli)
    jcli.run_inference(jload(str(d / f"{name}.yaml")), str(d / "images"),
                       str(d / f"j_{name}"))
    assert pcli.main(["--cfg", str(d / f"{name}.yaml"), "--ckpt",
                      f"{d / f'{name}_ckpt'}@best", "--device", "cpu",
                      f"images_dir={d / 'images'}",
                      f"output_dir={d / f't_{name}'}"]) == 0
    assert len(pcalls) == len(jcalls) == 5
    drawn = 0
    for (pk, ps, pv), (jk, js, jv) in zip(pcalls, jcalls):
        np.testing.assert_array_equal(pv, jv)
        drawn += int(pv.sum())
        if branch == "yolo":
            np.testing.assert_allclose(pk[pv], jk[jv],
                                       atol=1e-5 * np.abs(jk).max())
            np.testing.assert_allclose(ps[pv], js[jv], rtol=1e-5)
        else:
            np.testing.assert_allclose(pk[pv][..., :2], jk[jv][..., :2],
                                       atol=1e-4)
            np.testing.assert_allclose(pk[pv][..., 2], jk[jv][..., 2],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(ps[pv], js[jv], rtol=1e-4)
    assert drawn > 0
    want = sorted(p.name for p in (d / f"j_{name}").iterdir())
    got = sorted(p.name for p in (d / f"t_{name}").iterdir())
    assert got == want == [f"f_{i}.png" for i in range(5)]
    for n in got:
        assert Image.open(d / f"t_{name}" / n).size == (80, 48)


@pytest.mark.parametrize("branch", ["yolo", "bottom_up"])
def test_run_inference_int8_and_random_weights(infer_dir, branch, capsys):
    """eval.int8 (calibrated on the first image) through either branch,
    without --ckpt: a warning says the weights are random, every image
    is written, and run_inference returns its count and seconds."""
    from tpupose_torch.cli.test import run_inference
    from tpupose_torch.configs import load_config

    d = infer_dir
    name = "det" if branch == "yolo" else "bu"
    cfg = load_config(str(d / f"{name}.yaml"), {"eval.int8": "true"})
    stats = run_inference(cfg, str(d / "images"), str(d / f"i8_{name}"),
                          device="cpu")
    assert stats["images"] == 5 and stats["seconds"] > 0
    assert len(list((d / f"i8_{name}").iterdir())) == 5
    out = capsys.readouterr().out
    assert "random weights" in out and "int8 serving: calibrated" in out


def test_run_inference_defaults_to_cuda(infer_dir, monkeypatch):
    """Without --device cpu the CLI asks for CUDA and raises where there
    is none, before it reads an image."""
    from tpupose_torch.cli.test import main, run_inference
    from tpupose_torch.configs import load_config

    d = infer_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("det", "bu"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_inference(load_config(str(d / f"{name}.yaml")),
                          str(d / "images"), str(d / "t_none"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--cfg", str(d / f"{name}.yaml"),
                  f"images_dir={d / 'images'}",
                  f"output_dir={d / 't_none'}"])
    assert not (d / "t_none").exists()
