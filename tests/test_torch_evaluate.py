"""Metric evaluation through the port (TopDownEvaluator.run,
Trainer.evaluate, cli.train --test) against the JAX package on the CPU,
float32, with the JAX parameters carried into the port by
`from_flax_simple_baseline`.

Tolerances: source coordinates within 1e-3 px, every metric within 1e-4,
the same results-JSON keys and instance count; the CLI's printed numbers
(four decimals) within 1e-4. And the stale-weight trap: the trainer's
evaluator re-folds the R50 kernel route's weights from the current (EMA)
weights at every evaluate(), so a train step between two calls changes
the result, which equals a freshly built evaluator's.
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.data.coco import CocoTopDownDataset as JCoco
from tpupose.data.loader import BatchLoader as JLoader
from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.train_state import TrainState as JState
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from tpupose_torch.data.coco import CocoTopDownDataset as PCoco
from tpupose_torch.data.loader import BatchLoader as PLoader
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.utils.convert import from_flax_simple_baseline
from torch_threads import one_torch_thread  # noqa: F401

K = 4
PAIRS = np.array([(1, 2)])
METRIC_TOL = 1e-4


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """6 images of 1-3 persons, K=4 keypoints each, Gaussian blobs at the
    keypoints painted one channel per keypoint, the fourth on the first
    (so a 4x average pool of the image, channel 0 repeated, is a perfect
    heatmap model); one crowd annotation."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco_eval")
    (root / "val2017").mkdir()
    (root / "annotations").mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(6):
        H0, W0 = 240, 320
        img = np.zeros((H0, W0, 3), np.float32)
        ys, xs = np.mgrid[0:H0, 0:W0].astype(np.float32)
        for p in range(1 + i % 3):
            x0, y0, w, h = 10 + 100 * p, 30, 90, 150
            kp = []
            for k in range(K):
                kx = x0 + rng.uniform(0.25, 0.75) * w
                ky = y0 + rng.uniform(0.25, 0.75) * h
                v = 2 if rng.uniform() > 0.15 else 0
                if k == 3:                  # on keypoint 0, channel 0
                    kx, ky = kp[0], kp[1]
                kp += [float(kx), float(ky), v]
                if k < 3:
                    img[..., k] += np.exp(-((xs - kx) ** 2 + (ys - ky) ** 2)
                                          / (2 * 6.0 ** 2))
            anns.append({"id": len(anns), "image_id": i, "category_id": 1,
                         "bbox": [x0, y0, w, h], "keypoints": kp,
                         "num_keypoints": K, "area": w * h * 0.6,
                         "iscrowd": int(len(anns) == 4)})
        name = f"{i:012d}.jpg"
        Image.fromarray(np.clip(img * 255, 0, 255).astype(np.uint8)).save(
            root / "val2017" / name, quality=98)
        images.append({"id": i, "file_name": name, "width": W0,
                       "height": H0})
    with open(root / "annotations" / "person_keypoints_val2017.json",
              "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return root


def _loaders(root, hw, hm, udp=False):
    kw = dict(image_dir=str(root / "val2017"),
              ann_file=str(root / "annotations"
                           / "person_keypoints_val2017.json"),
              image_size=hw, heatmap_size=hm, is_train=False,
              flip_pairs=PAIRS, udp=udp)
    lk = dict(batch_size=4, shuffle=False, drop_last=False, pad_last=True)
    return JLoader(JCoco(**kw), **lk), PLoader(PCoco(**kw), **lk)


def _metrics(mod):
    import importlib

    m = importlib.import_module(f"{mod}.metrics")
    sig = np.full(K, 0.08, np.float32)
    return [m.PCK(alpha=0.2), m.MPJPE(), m.OKSAP(num_classes=1, sigmas=sig),
            m.AUC(), m.EPE()]


def _assert_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= METRIC_TOL * max(1.0, abs(w)), (k, got[k], w)


def _assert_results(got_path, want_path, atol):
    got, want = (json.load(open(p)) for p in (got_path, want_path))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["image_id"] == w["image_id"]
        assert g["category_id"] == w["category_id"] == 1
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=atol)
        assert abs(g["score"] - w["score"]) <= 2e-5


@pytest.fixture(scope="module")
def r18():
    """A flax SimpleBaseline-R18 (4 keypoints) with non-trivial BatchNorm
    statistics and its port twin."""
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(4))
    tm = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=torch.float32,
                        device="cpu")
    tm.load_state_dict(from_flax_simple_baseline(v))
    return jm, v, tm


def _randomize_bn(tree, rs):
    """Non-trivial BatchNorm scale/bias/mean/var in a flax tree."""
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


def _jstate(apply_fn, v):
    return JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                  batch_stats=v.get("batch_stats", {}), opt_state=(),
                  apply_fn=apply_fn, tx=optax.sgd(0.0))


def _assert_steps(jev, pev, jl, pl, px_tol=None, hm_px_tol=None):
    """Each batch's source coordinates within px_tol, or within hm_px_tol
    heatmap px (scaled by the batch's largest crop scale), and scores
    within 1e-4."""
    for jb, pb in zip(jl, pl):
        want = jev.step(jb["images"], jb["center"], jb["scale"])
        got = pev.step(pb["images"], pb["center"], pb["scale"])
        tol = px_tol if px_tol is not None else hm_px_tol * float(
            np.max(pb["scale"] / np.asarray(jev.heatmap_size[::-1])))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=tol)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flip", [True, False])
def test_run_matches_jax(r18, coco_root, tmp_path, flip):
    """SimpleBaseline-R18 at 64x64 over the COCO-format set (padded tail
    batch, multi-person images regrouped by image id): every metric within
    1e-4 and the same results JSON. Coordinates within 2e-2 heatmap px:
    a random model's heatmaps are flat fields without peaks, on which
    DARK's Newton step is ill-conditioned (the JAX decode and the port's
    give the same such maps coordinates up to 6e-3 px apart, against
    1e-4 on Gaussian peaks, tests/test_torch_ops.py); the peaked
    heatmaps of the next test hold them at 1e-3 source px."""
    jm, v, tm = r18
    jl, pl = _loaders(coco_root, (64, 64), (16, 16))
    jev = JEvaluator(_jstate(jm.apply, v), (16, 16), flip_test=flip,
                     flip_pairs=PAIRS)
    pev = TopDownEvaluator(tm, (16, 16), flip_test=flip, flip_pairs=PAIRS,
                           device="cpu")
    _assert_steps(jev, pev, jl, pl, hm_px_tol=2e-2)
    want = jev.run(jl, _metrics("tpupose"),
                   results_path=str(tmp_path / "j" / "res.json"))
    got = pev.run(pl, _metrics("tpupose_torch"),
                  results_path=str(tmp_path / "p" / "res.json"))
    assert {"pck", "mpjpe", "mAP", "AP_M", "AR", "auc", "epe"} <= set(got)
    _assert_metrics(got, want)
    _assert_results(tmp_path / "p" / "res.json", tmp_path / "j" / "res.json",
                    atol=2e-2 * 150 * 1.25 / 16)
    # one entry per kept (non-crowd, non-padded) instance
    assert len(json.load(open(tmp_path / "p" / "res.json"))) == 11


def test_dark_on_a_random_models_heatmaps_sets_the_coordinate_floor(
        r18, coco_root):
    """Why test_run_matches_jax holds coordinates at 2e-2 heatmap px: the
    JAX decode and the port's, given the very same flat heatmaps of the
    random R18, already disagree by more than the 1e-3 px they hold on
    Gaussian peaks (tests/test_torch_ops.py: 1e-4). Prints the size
    with -s."""
    from tpupose.ops.decode import decode_heatmaps as j_decode
    from tpupose.ops.preprocess import normalize_images as j_normalize
    from tpupose_torch.ops.decode import decode_heatmaps as p_decode

    jm, v, _ = r18
    jl, _ = _loaders(coco_root, (64, 64), (16, 16))
    d = 0.0
    for b in jl:
        hm = np.array(jnp.transpose(jm.apply(
            v, j_normalize(jnp.asarray(b["images"])), train=False),
            (0, 3, 1, 2)))
        want, _ = j_decode(jnp.asarray(hm), "dark", 11, 2.0)
        got, _ = p_decode(torch.from_numpy(hm), "dark", 11, 2.0)
        d = max(d, float(np.abs(got.numpy() - np.asarray(want)).max()))
    print(f"DARK on the same random-model heatmaps, JAX vs port: {d:.3g} px")
    assert 1e-3 < d < 2e-2


class JPool(nn.Module):
    """A perfect heatmap model: undo the normalize, 4x average pool."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        gain = self.param("gain", nn.initializers.ones, ())
        x = x.astype(jnp.float32) * jnp.asarray(IMAGENET_STD) \
            + jnp.asarray(IMAGENET_MEAN)
        hm = nn.avg_pool(x, (4, 4), strides=(4, 4)) * 16.0 * gain
        return jnp.concatenate([hm, hm[..., :1]], -1)


class PPool(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.ones(()))

    def forward(self, x):
        x = x.float() * torch.tensor(IMAGENET_STD) + torch.tensor(
            IMAGENET_MEAN)
        hm = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 4) \
            .permute(0, 2, 3, 1) * 16.0 * self.gain
        return torch.cat([hm, hm[..., :1]], -1)


@pytest.mark.parametrize("flip", [True, False])
def test_run_matches_jax_with_a_perfect_model(coco_root, flip):
    """Heatmaps that peak at the ground truth: source coordinates within
    1e-3 px, OKS-AP near 1 through the greedy matching of multi-person
    images, every metric equal to JAX's within 1e-4."""
    jl, pl = _loaders(coco_root, (128, 96), (32, 24))
    v = JPool().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 96, 3)))
    # no pairs: the painted channels have no left/right twins
    pairs = np.zeros((0, 2), np.int64)
    jev = JEvaluator(_jstate(JPool().apply, v), (32, 24), flip_test=flip,
                     flip_pairs=pairs)
    pev = TopDownEvaluator(PPool(), (32, 24), flip_test=flip,
                           flip_pairs=pairs, device="cpu")
    _assert_steps(jev, pev, jl, pl, px_tol=1e-3)
    want = jev.run(jl, _metrics("tpupose"))
    got = pev.run(pl, _metrics("tpupose_torch"))
    assert got["mAP50"] > 0.9 and got["pck"] > 0.9, got
    _assert_metrics(got, want)


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
@pytest.mark.parametrize("decode", ["dark", "quarter_offset", "argmax"])
@pytest.mark.parametrize("udp", [False, True], ids=["classic", "udp"])
def test_evaluator_grid_matches_jax(coco_root, udp, decode, flip):
    """The evaluator's option grid, udp (the dataset's and the
    evaluator's) x decode x flip, on the perfect pool model over the
    COCO-format set: each batch's source coordinates within 1e-4 px and
    scores within 1e-5 of JAX's; every unitless metric (PCK, AP, AR,
    AUC) within 1e-6, the pixel ones (MPJPE, EPE) within 1e-5 px: source
    coordinates up to 320 px carry float32's 3e-5 px resolution."""
    jl, pl = _loaders(coco_root, (128, 96), (32, 24), udp=udp)
    v = JPool().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 96, 3)))
    pairs = np.zeros((0, 2), np.int64)
    kw = dict(decode=decode, flip_test=flip, flip_pairs=pairs, udp=udp)
    jev = JEvaluator(_jstate(JPool().apply, v), (32, 24), **kw)
    pev = TopDownEvaluator(PPool(), (32, 24), device="cpu", **kw)
    for jb, pb in zip(jl, pl):
        wc, ws = jev.step(jb["images"], jb["center"], jb["scale"])
        gc, gs = pev.step(pb["images"], pb["center"], pb["scale"])
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-7)
    want = jev.run(jl, _metrics("tpupose"))
    got = pev.run(pl, _metrics("tpupose_torch"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        tol = 1e-5 if k in ("mpjpe", "epe") else 1e-6
        assert abs(got[k] - w) <= tol * max(1.0, abs(w)), (k, got[k], w)


def test_run_keeps_two_batches_in_flight_in_loader_order(r18, coco_root,
                                                         monkeypatch):
    """Batch i's results are accumulated only after batch i+2 was
    dispatched, in the loader's order."""
    _, _, tm = r18
    _, pl = _loaders(coco_root, (64, 64), (16, 16))
    pev = TopDownEvaluator(tm, (16, 16), flip_test=False, flip_pairs=PAIRS,
                           device="cpu")
    events = []
    real_step = pev.step

    def step(images, c, s):
        events.append(("step", len(events)))
        return real_step(images, c, s)

    class Probe:
        def update(self, coords, gt, vis):
            events.append(("acc", len(coords)))

        def compute(self):
            return {}

    monkeypatch.setattr(pev, "step", step)
    pev.run(pl, [Probe()])
    kinds = [k for k, _ in events]
    assert kinds == ["step", "step", "step", "acc", "acc", "acc"]
    assert [n for k, n in events if k == "acc"] == [4, 4, 3]


def _tiny_cfg(mod, tmp_path, **over):
    import importlib

    cfg = importlib.import_module(f"{mod}.configs").default_config()
    cfg.model.backbone = "resnet18"
    cfg.model.num_keypoints = K
    cfg.model.heatmap_size = (16, 16)
    cfg.model.deconv_channels = (32, 32, 32)
    cfg.data.image_size = (64, 64)
    cfg.train.batch_size = 16
    cfg.train.epochs = 1
    cfg.train.warmup_epochs = 0
    cfg.train.mixed_precision = False
    cfg.train.log_interval = 100
    cfg.train.output_dir = str(tmp_path / mod)
    cfg.eval.metrics = ("pck", "mpjpe", "oks_ap", "auc", "epe")
    for k, val in over.items():
        sec, key = k.split(".")
        setattr(getattr(cfg, sec), key, val)
    return cfg


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """JAX's Trainer and the port's on the same config, the JAX
    parameters carried into the port's model."""
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.trainer import Trainer as PTrainer

    tmp = tmp_path_factory.mktemp("tr")
    jt = JTrainer(_tiny_cfg("tpupose", tmp))
    pt = PTrainer(_tiny_cfg("tpupose_torch", tmp), device="cpu")
    v = {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}
    pt.model.load_state_dict(from_flax_simple_baseline(v))
    return jt, pt


def test_trainer_evaluate_matches_jax(trainers):
    jt, pt = trainers
    want, got = jt.evaluate(), pt.evaluate()
    assert {"pck", "mpjpe", "mAP", "mAP50", "mAP75", "auc", "epe"} <= set(got)
    _assert_metrics(got, want)


def test_cli_test_prints_jax_numbers(trainers, monkeypatch, capsys):
    """`cli.train --test` of both packages on the same weights: the
    validation loss and every metric, as printed."""
    import re

    import tpupose.cli.train as jcli
    import tpupose_torch.cli.train as pcli

    jt, pt = trainers
    printed = {}
    for name, cli, tr in (("jax", jcli, jt), ("port", pcli, pt)):
        monkeypatch.setattr(cli, "Trainer", lambda cfg, tr=tr, **kw: tr)
        argv = ["--test"] + (["--device", "cpu"] if name == "port" else [])
        assert cli.main(argv) == 0
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if "validation loss:" in ln][-1]
        printed[name] = dict(re.findall(r"(\w+)[=:] ?(-?[\d.]+)", line))
    assert "mAP" in printed["port"] and "loss" in printed["port"]
    assert sorted(printed["port"]) == sorted(printed["jax"])
    for k, w in printed["jax"].items():
        assert abs(float(printed["port"][k]) - float(w)) <= 1e-4 + 1e-9, k


def test_run_metrics_in_the_epoch_loop(tmp_path):
    """eval.run_metrics: train() evaluates at eval.interval and writes the
    metrics to log.txt and to eval/ scalars; eval.dump_results writes the
    results JSON."""
    from tpupose.utils.tensorboard import read_scalars
    from tpupose_torch.engine.trainer import Trainer

    res = tmp_path / "res.json"
    cfg = _tiny_cfg("tpupose_torch", tmp_path, **{
        "eval.run_metrics": True, "eval.dump_results": str(res),
        "train.tensorboard": True})
    tr = Trainer(cfg, device="cpu")
    tr.train()
    exp = tmp_path / "tpupose_torch" / cfg.train.experiment
    log = (exp / "log.txt").read_text()
    assert "epoch 0: pck=" in log and "mAP=" in log
    tags = {t for p in (exp / "tb").iterdir() for t, _, _ in
            read_scalars(str(p))}
    assert {"eval/pck", "eval/mpjpe", "eval/mAP"} <= tags
    assert len(json.load(open(res))) == len(tr.valid_ds) == 64


@pytest.mark.parametrize("key,value,item", [
    ("eval.det_boxes", "dets.json", "item 11")])
def test_unported_eval_options_raise(tmp_path, key, value, item):
    """Every evaluation option is ported now: eval.int8 / int8_engine
    (held against JAX in tests/test_torch_int8_eval.py) and, since Queue
    A `item`, detection-box evaluation (tests/test_torch_det_eval.py).
    Neither Trainer() nor evaluate() raises for it; on a dataset that is
    not COCO-format evaluate() skips the protocol with a warning, as
    JAX's does, and reports no det_* metric."""
    from tpupose_torch.engine.trainer import Trainer

    tr = Trainer(_tiny_cfg("tpupose_torch", tmp_path, **{
        key: value, "eval.run_metrics": True}), device="cpu")
    out = tr.evaluate()
    assert "pck" in out and not any(k.startswith("det_") for k in out)
    assert tr.evaluate_detections(value) == {}


def test_evaluate_refolds_the_r50_route_after_training(tmp_path):
    """The stale-weight trap. SimpleBaseline-R50 at 256x192 takes the
    kernel route (plain versions on the CPU) on weights folded from the
    EMA; one train step between two evaluate() calls must change the
    predictions, and the second call must equal a freshly built
    evaluator on the current EMA weights."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.trainer import Trainer

    res = tmp_path / "res.json"
    cfg = load_config("tpupose/configs/method/simple_baseline.yaml", {
        "train.mixed_precision": "false", "train.ema_decay": "0.9",
        "train.output_dir": str(tmp_path), "eval.dump_results": str(res),
        "eval.metrics": "['pck', 'mpjpe']"})
    tr = Trainer(cfg, device="cpu")
    ds = SyntheticTopDownDataset(2, (256, 192), (64, 48), 17, seed=1)
    tr.valid_ds = ds
    tr.valid_loader = PLoader(ds, 2, shuffle=False, drop_last=False,
                              pad_last=True)
    tr.evaluate()
    ev = tr._evaluator
    assert ev.fast_weights is not None and ev.model is tr.state._eval_model
    first = json.load(open(res))
    folded = ev.fast_weights["stem"]["w"].clone()

    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(2)]))
             for k in ("image", "joints", "visibility")}
    batch["images"] = batch.pop("image")
    tr.train_step(tr.state, batch)
    second_metrics = tr.evaluate()
    assert tr._evaluator is ev
    second = json.load(open(res))
    assert not torch.equal(ev.fast_weights["stem"]["w"], folded)
    assert any(a["keypoints"] != b["keypoints"]
               for a, b in zip(first, second))

    fresh = TopDownEvaluator(tr.state.for_eval(), (64, 48), flip_test=True,
                             flip_pairs=None, device="cpu")
    fresh_metrics = fresh.run(tr._eval_batches(),
                              tr._build_eval_metrics(),
                              results_path=str(tmp_path / "fresh.json"))
    assert json.load(open(tmp_path / "fresh.json")) == second
    assert fresh_metrics == second_metrics
