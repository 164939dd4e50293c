"""The port's export CLI (tpupose_torch/cli/export.py) as JAX's export-CLI
tests drive theirs (tests/test_predictor_exporter_tracker.py): the npz,
pt2 and both formats of a heatmap model, the refusals, and the int8,
simcc and bottom-up programs.

Tolerances: npz weights exactly; a loaded program equals the eager step
of the same seeded model bit for bit (the int8 program: the eager
quantized step calibrated on the same images).
"""

import numpy as np
import pytest
import torch

from tpupose_torch.engine import exporter
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.engine.predictor import HeatmapPredictor

from test_torch_export import T, _crops
from torch_threads import one_torch_thread  # noqa: F401

CLI_TINY = ["model.backbone=resnet18", "model.num_keypoints=4",
            "data.image_size=[64,64]", "model.heatmap_size=[16,16]",
            "model.deconv_channels=[16,16,16]",
            "train.mixed_precision=false", "eval.flip_test=false"]


@pytest.mark.parametrize("fmt,files", [("npz", [".npz"]), ("pt2", [".pt2"]),
                                       ("both", [".npz", ".pt2"])])
def test_export_cli_formats(tmp_path, fmt, files):
    """cli.export writes the formats asked for; the program equals the
    eager step of the same seeded model and the npz its weights."""
    from tpupose_torch.cli.export import main
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder

    out = str(tmp_path / "model")
    cfg_path = "tpupose_torch/configs/method/simple_baseline.yaml"
    assert main(["--cfg", cfg_path, "--device", "cpu", *CLI_TINY,
                 f"out={out}", f"format={fmt}", "batch=2"]) == 0
    assert sorted(p.suffix for p in tmp_path.iterdir()) == sorted(files)
    cfg = load_config(cfg_path, dict(o.split("=", 1) for o in CLI_TINY))
    m = Builder(cfg, "cpu").model().eval()
    if ".npz" in files:
        sd = exporter.npz_state_dict(exporter.load_npz(out + ".npz"))
        for k, t in m.state_dict().items():
            assert torch.equal(sd[k], t), k
    if ".pt2" in files:
        ev = TopDownEvaluator(m, (16, 16), flip_test=False, device="cpu")
        imgs, c, s = _crops(seed=5)
        got = exporter.load_program(out + ".pt2")(T(imgs), T(c), T(s))
        for g, e in zip(got, ev.step(imgs, c, s)):
            assert torch.equal(g, e)


@pytest.mark.parametrize("fmt,match", [("stablehlo", "format=pt2"),
                                       ("onnx", "unknown format")])
def test_export_cli_refuses_other_formats(tmp_path, fmt, match):
    from tpupose_torch.cli.export import main

    with pytest.raises(ValueError, match=match):
        main(["--cfg", "tpupose_torch/configs/method/simple_baseline.yaml",
              "--device", "cpu", *CLI_TINY, f"out={tmp_path / 'm'}",
              f"format={fmt}"])


@pytest.mark.parametrize("family", ["int8", "simcc", "bottom_up"])
def test_export_cli_int8_and_families(tmp_path, family):
    """cli.export's routes, as JAX's CLI tests drive them: the simcc and
    bottom-up families' programs load back and give finite outputs of
    their shapes; the int8 program (calib=<.npy>) holds int8 tensors and
    equals the eager quantized step of the same seeded model calibrated
    on the same images."""
    from tpupose_torch.cli.export import main

    imgs, c, s = _crops(seed=6)
    out = str(tmp_path / family)
    if family == "int8":
        calib = str(tmp_path / "calib.npy")
        np.save(calib, np.random.RandomState(0).randint(
            0, 256, (2, 64, 64, 3)).astype(np.uint8))
        main(["--cfg", "tpupose_torch/configs/method/simple_baseline.yaml",
              "--device", "cpu", *CLI_TINY, "eval.int8=true",
              f"calib={calib}", f"out={out}", "format=pt2", "batch=2"])
    elif family == "simcc":
        main(["--cfg", "tpupose_torch/configs/method/simcc_r50.yaml",
              "--device", "cpu", "model.backbone=resnet18",
              "model.num_keypoints=4", "data.image_size=[64,64]",
              "model.split_ratio=1.0", "model.heatmap_size=[64,64]",
              "train.mixed_precision=false", "eval.flip_test=false",
              f"out={out}", "format=pt2", "batch=2"])
    else:
        main(["--cfg", "tpupose_torch/configs/method/bottom_up_w32.yaml",
              "--device", "cpu", "model.backbone=resnet18",
              "model.deconv_channels=[32,32,32]", "model.num_keypoints=3",
              "model.heatmap_size=[16,16]", "data.image_size=[64,64]",
              "data.max_instances=5", "train.mixed_precision=false",
              f"out={out}", "format=pt2", "batch=2"])
    prog = exporter.load_program(out + ".pt2")
    if family == "bottom_up":
        got = prog(T(imgs))
        assert sorted(tuple(g.shape) for g in got) == sorted(
            [(2, 5, 3, 2), (2, 5, 3), (2, 5), (2, 5)])
        return
    coords, scores = prog(T(imgs), T(c), T(s))
    assert coords.shape == (2, 4, 2) and scores.shape == (2, 4)
    assert torch.isfinite(coords).all() and torch.isfinite(scores).all()
    if family == "int8":
        from tpupose_torch.configs import load_config
        from tpupose_torch.engine.builder import Builder

        assert any(getattr(n.meta.get("val"), "dtype", None) == torch.int8
                   for n in prog.graph.nodes)
        cfg = load_config("tpupose_torch/configs/method/simple_baseline.yaml",
                          dict(o.split("=", 1) for o in CLI_TINY))
        m = Builder(cfg, "cpu").model().eval()
        ev = TopDownEvaluator(m, (16, 16), flip_test=False, device="cpu",
                              quant_scales=HeatmapPredictor.calibrate_int8(
                                  m, np.load(calib)))
        want = ev.step(imgs, c, s)
        assert torch.equal(coords, want[0]) and torch.equal(scores, want[1])
