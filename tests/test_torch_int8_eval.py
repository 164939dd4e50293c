"""int8 evaluation in the port, on the CPU:

  - eval.int8 (the PTQ intercept) and eval.int8_engine (the Int8Engine)
    through Trainer.evaluate, against JAX's Trainer on the same weights,
    for SimpleBaseline-R18 and the tiny HRNet of
    tests/test_torch_quant.py. Each trainer calibrates on its first
    validation batch against its eval weights at every call. The int8
    forward itself is held against JAX's in tests/test_torch_quant.py
    and tests/test_torch_int8_engine.py; here JAX's evaluator is given
    the port's int8 forward (a host callback, as
    tests/test_torch_int8.py does for the R50 engine), so the comparison
    holds everything around it: calibration batch and weights, the
    evaluator's flip of the raw pixels, merge, decode, back-projection,
    the metrics and the results JSON. Coordinates within 2e-2 heatmap
    px (tests/test_torch_evaluate.py's floor for DARK on a random
    model's flat heatmaps), metrics within 1e-3 of their size.
  - the port's twin of tests/test_int8_metric_parity.py: a SimpleBaseline
    -R18 with K = 3 at 64x64 overfit on 8 synthetic crops until the loss
    is below 1e-3; then the PTQ intercept and the Int8Engine move PCK by
    less than 0.5 pt and the keypoints by less than 0.5 heatmap px on
    average, the JAX test's bars. It runs in Tier-1's time (the JAX test
    is marked slow).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.ops import int8_engine as j_int8
from tpupose_torch.ops import int8_engine as t_int8

from test_torch_quant import (  # noqa: F401
    HW, K, _pair, one_torch_thread, tiny_spec)

T = torch.from_numpy


@pytest.fixture(scope="module")
def models(tiny_spec):  # noqa: F811
    return {n: _pair(n) for n in HW}


def _tiny_cfg(mod, tmp_path, name, **over):
    import importlib

    cfg = importlib.import_module(f"{mod}.configs").default_config()
    if name == "resnet18":
        cfg.model.backbone = "resnet18"
        cfg.model.deconv_channels = (32, 32, 32)
        cfg.model.heatmap_size = (16, 16)
    else:
        cfg.model.name = "hrnet"
        cfg.model.backbone = name
        cfg.model.heatmap_size = (16, 12)
    cfg.data.image_size = HW[name]
    cfg.model.num_keypoints = K
    cfg.train.batch_size = 16
    cfg.train.epochs = 1
    cfg.train.mixed_precision = False
    cfg.train.output_dir = str(tmp_path / mod)
    cfg.eval.batch_size = 32
    cfg.eval.metrics = ("pck", "mpjpe", "oks_ap")
    for k, val in over.items():
        sec, key = k.split(".")
        setattr(getattr(cfg, sec), key, val)
    return cfg


@pytest.mark.parametrize("name,option", [
    ("resnet18", "int8"), ("resnet18", "int8_engine"),
    ("hrnet_t8", "int8"), ("hrnet_t8", "int8_engine")])
def test_trainer_evaluate_int8_matches_jax(models, name, option, tmp_path,
                                           monkeypatch):
    import tpupose.ops.quant as j_quant
    from tpupose.engine.predictor import HeatmapPredictor as JPredictor
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.engine.trainer import Trainer as PTrainer
    from tpupose_torch.ops.quant import quantized_apply

    jm, v, tm, paths = models[name]
    res = {m: tmp_path / f"{m}.json" for m in ("jax", "port")}
    over = {f"eval.{option}": True}
    pt = PTrainer(_tiny_cfg("tpupose_torch", tmp_path, name, **over, **{
        "eval.dump_results": str(res["port"])}), device="cpu")
    pt.model.load_state_dict(tm.state_dict())
    seen = {}
    if option == "int8_engine":
        real = t_int8.Int8Engine.build
        monkeypatch.setattr(t_int8.Int8Engine, "build", lambda *a, **k:
                            seen.setdefault("port", real(*a, **k)))
    else:
        real = HeatmapPredictor.calibrate_int8
        monkeypatch.setattr(HeatmapPredictor, "calibrate_int8", staticmethod(
            lambda *a: seen.setdefault("port", real(*a))))
    got = pt.evaluate()
    ev = pt._evaluator
    assert (ev.int8_engine is seen.get("port")) == (option == "int8_engine")
    assert (ev.quant_scales == seen.get("port")) == (option == "int8")
    hm = tuple(pt.cfg.model.heatmap_size)

    def callback(fn):
        return lambda x: jax.pure_callback(
            lambda a: fn(np.asarray(a, np.float32)).numpy(),
            jax.ShapeDtypeStruct((x.shape[0], *hm, K), jnp.float32), x)

    if option == "int8_engine":
        class Slot:                  # the JAX evaluator's int8_engine slot
            _qw = ()

            def forward_traceable(self, im, qw):
                return callback(lambda a: seen["port"](a.astype(np.uint8)))(
                    im)

        monkeypatch.setattr(j_int8.Int8Engine, "build",
                            lambda *a, **k: Slot())
    else:
        jreal = JPredictor.calibrate_int8
        monkeypatch.setattr(JPredictor, "calibrate_int8", staticmethod(
            lambda *a: seen.setdefault("jax", jreal(*a))))
        monkeypatch.setattr(j_quant, "quantized_apply", lambda f, v_, s, x,
                            **kw: callback(lambda a: quantized_apply(
                                ev.model, seen["port"], T(a)))(x))
    # one device: the host callback takes the whole batch
    jt = JTrainer(_tiny_cfg("tpupose", tmp_path, name, **over, **{
        "eval.dump_results": str(res["jax"]), "mesh.data": 1}))
    jt.state = jt.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    want = jt.evaluate()
    if option == "int8":             # the two calibrations, by name
        assert {paths[n] for n in seen["port"]} == set(seen["jax"])
        for n, a in seen["port"].items():
            assert a == pytest.approx(seen["jax"][paths[n]], rel=1e-5), n
    for k in ("pck", "mpjpe", "mAP"):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-3), k
    jr, pr = (json.load(open(res[m])) for m in ("jax", "port"))
    assert len(jr) == len(pr) == len(pt.valid_ds)
    jk = np.array([r["keypoints"] for r in jr]).reshape(len(jr), K, 3)
    pk = np.array([r["keypoints"] for r in pr]).reshape(len(pr), K, 3)
    px = float(np.max(np.asarray(pt.valid_ds.scales)
                      / np.array(hm[::-1])))
    d = np.abs(pk[..., :2] - jk[..., :2]).max()
    print(f"{name} eval.{option}: max coordinate difference "
          f"{d / px:.3g} heatmap px")
    assert d <= 2e-2 * px


def test_serve_and_evaluate_share_one_int8_engine_rule(models, tmp_path,
                                                       monkeypatch):
    """eval.int8_engine picks its engine in one place
    (ops/int8_engine.build_int8_engine), which cli.serve and
    Trainer.evaluate both call: the R50 gets CudaServingEngine (K5/K6),
    the R18 and HRNet the Int8Engine."""
    from tpupose_torch.cli.serve import build_predictor
    from tpupose_torch.engine.trainer import Trainer
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops.cuda_engine import CudaServingEngine

    built = []
    monkeypatch.setattr(CudaServingEngine, "build", classmethod(
        lambda cls, *a, **k: built.append("cuda") or "cuda"))
    monkeypatch.setattr(t_int8.Int8Engine, "build", classmethod(
        lambda cls, *a, **k: built.append("int8") or "int8"))
    calib = np.zeros((2, 64, 64, 3), np.uint8)
    for model, want in (
            (SimpleBaseline("resnet50", K, (32, 32, 32), dtype=torch.float32,
                            device="cpu"), "cuda"),
            (models["resnet18"][2], "int8"), (models["hrnet_t8"][2], "int8")):
        assert t_int8.build_int8_engine(model, calib, device="cpu") == want
    assert built == ["cuda", "int8", "int8"]

    callers = []
    real = t_int8.build_int8_engine
    monkeypatch.undo()
    monkeypatch.setattr(t_int8, "build_int8_engine", lambda *a, **k: (
        callers.append(type(a[0]).__name__) or real(*a, **k)))
    cfg = _tiny_cfg("tpupose_torch", tmp_path, "resnet18",
                    **{"eval.int8_engine": True})
    pred = build_predictor(cfg, "", "cpu")
    tr = Trainer(cfg, device="cpu")
    tr.evaluate()
    assert callers == ["SimpleBaseline", "SimpleBaseline"]
    assert type(pred.evaluator.int8_engine) is type(
        tr._evaluator.int8_engine) is t_int8.Int8Engine


# -- the twin of tests/test_int8_metric_parity.py ------------------------------

@pytest.fixture(scope="module")
def trained_r18():
    """SimpleBaseline-R18, K = 3, 64x64, deconvs of 64, overfit on 8
    synthetic crops with Adam 3e-3 and clip 10 (the JAX test's recipe)
    until the loss is below 1e-3."""
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_heatmap_train_step)
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.models.simple_baseline import (SimpleBaseline,
                                                      init_like_flax)

    torch.manual_seed(0)
    ds = SyntheticTopDownDataset(8, (64, 64), (16, 16), 3, seed=0)
    smp = [ds[i] for i in range(8)]
    imgs = np.stack([s["image"] for s in smp])
    joints = np.stack([s["joints"] for s in smp])
    vis = np.stack([s["visibility"] for s in smp])
    model = SimpleBaseline("resnet18", 3, (64, 64, 64), dtype=torch.float32,
                           device="cpu")
    init_like_flax(model, torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(
        OptimizerConfig(name="adam", lr=3e-3), model.named_parameters(),
        grad_clip_norm=10.0))
    step = make_heatmap_train_step(joints_mse_loss, heatmap_size=(16, 16))
    batch = {"images": T(imgs), "joints": T(joints), "visibility": T(vis)}
    steps, loss = 0, float("inf")
    while loss >= 1e-3 and steps < 600:
        loss = float(step(state, batch)["loss"])
        steps += 1
    print(f"R18 K=3 64x64: loss {loss:.3g} after {steps} steps")
    assert loss < 1e-3
    return model.eval(), imgs, joints, vis


def _pck(coords, joints, vis, thresh_px=3.2):
    """PCK on the 16x16 heatmap grid (0.2 * 16 px), the JAX test's."""
    err = np.linalg.norm(np.asarray(coords) - joints, axis=-1)[vis > 0]
    return (err < thresh_px).mean()


def _decode(hm):
    from tpupose_torch.ops.decode import decode_heatmaps

    return decode_heatmaps(hm.permute(0, 3, 1, 2), "dark")[0].numpy()


def test_int8_paths_are_metric_neutral(trained_r18):
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.ops.preprocess import normalize_images
    from tpupose_torch.ops.quant import quantized_apply

    model, imgs, joints, vis = trained_r18
    x = normalize_images(T(imgs), dtype=torch.float32)
    with torch.no_grad():
        c_f = _decode(model(x))
    pck_f = _pck(c_f, joints, vis)
    assert pck_f > 0.9               # the model really localizes

    scales = HeatmapPredictor.calibrate_int8(model, imgs)
    c_q = _decode(quantized_apply(model, scales, normalize_images(
        T(imgs)).float()))
    eng = t_int8.Int8Engine.build(model, calib=[imgs], device="cpu")
    c_e = _decode(eng(imgs))
    m = vis > 0
    for label, c in (("ptq", c_q), ("int8_engine", c_e)):
        p = _pck(c, joints, vis)
        err = np.abs(c - c_f).max(axis=-1)[m].mean()
        print(f"{label}: PCK {p:.4f} (float32 {pck_f:.4f}), mean keypoint "
              f"difference {err:.4f} heatmap px")
        assert abs(p - pck_f) < 0.005, label
        assert err < 0.5, label
