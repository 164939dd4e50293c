"""The port's YOLO-format and MPII data (tpupose_torch/data/yolo_pose.py,
data/mpii.py, data/native_io.py's label parser and JPEG batch decode,
Builder.dataset's yolo_pose and mpii branches) against the JAX package's, on
files the tests write.

Tolerances: images equal byte for byte (each package's native path
against the other's, and each PIL path against the other's: the two
paths give different pixels, in JAX as in the port); labels, boxes,
keypoints, masks, centers, scales and joints within 1e-6 (the parsers
are the same C code and the same numpy). The MPII tests are the twins
of tests/test_mpii.py.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import tpupose.data.native_io as j_io
import tpupose_torch.data.native_io as p_io
from tpupose.data.mpii import MpiiTopDownDataset as JMpii
from tpupose.data.yolo_pose import YoloPoseDataset as JYolo
from tpupose_torch.data.mpii import MPII_FLIP_PAIRS, MpiiTopDownDataset
from tpupose_torch.data.yolo_pose import YoloPoseDataset

from torch_threads import one_torch_thread  # noqa: F401

K = 4
W0, H0 = 120, 100                      # the MPII source images


def _have_native():
    return bool(shutil.which("g++")) and Path(
        "/usr/include/jpeglib.h").exists()


@pytest.fixture(params=["native", "pil"])
def io_path(request, monkeypatch):
    """Both packages on their native library, or both on PIL / numpy."""
    if request.param == "native":
        if not _have_native():
            pytest.skip("g++ or jpeglib.h missing: no native path here")
        assert p_io.get_lib() is not None
        if j_io.get_lib() is None:
            # the JAX package builds its library in place, which a test
            # process can find half written (ROADMAP Queue C)
            pytest.skip("the JAX package's native library did not load")
    else:
        monkeypatch.setattr(p_io, "get_lib", lambda: None)
        monkeypatch.setattr(j_io, "get_lib", lambda: None)
    return request.param


def _row(rng, cls, kdim):
    r = [cls, *rng.uniform(0.2, 0.8, 2), *rng.uniform(0.05, 0.3, 2)]
    for _ in range(K):
        r += list(rng.uniform(0, 1, 2))
        if kdim == 3:
            r.append(float(rng.randint(0, 3)))
    return " ".join(f"{v:.6f}" for v in r)


@pytest.fixture(scope="module")
def yolo_root(tmp_path_factory):
    """images/ + labels/: jpg and png sources of two sizes; 3-dim labels,
    2-dim labels, one of 6 rows (above max_instances 4), an empty file,
    a malformed one (skipped), a missing one (no instances), blank lines
    and trailing spaces."""
    root = tmp_path_factory.mktemp("yolo")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(0)
    specs = [("a", "jpg", 3, 2), ("b", "png", 2, 1), ("c", "jpeg", 3, 6),
             ("d", "jpg", 3, 0), ("e", "png", 3, -1), ("f", "jpg", 3, None),
             ("g", "jpg", 2, 3)]
    for i, (stem, ext, kdim, n) in enumerate(specs):
        h, w = (96, 128) if i % 2 else (150, 110)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 0.6], -1)
        img = np.clip(img + rng.uniform(0, 20, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            root / "images" / f"{stem}.{ext}", quality=92)
        if n is None:
            continue
        lines = ([_row(rng, i % 3, kdim) for _ in range(n)] if n >= 0
                 else ["0 0.5 0.5 0.2"])             # malformed
        text = "\n".join(lines)
        if stem == "g":
            text = "\n" + text.replace("\n", "  \n\n") + "\n"
        (root / "labels" / f"{stem}.txt").write_text(text)
    return root


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if k == "image":
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("size,max_inst", [((64, 64), 4), ((48, 80), 8)])
def test_yolo_items_match_jax(yolo_root, io_path, size, max_inst):
    """Every item of the port's YoloPoseDataset equals JAX's: the same
    images kept (the malformed label's skipped), in the same order, with
    equal pixels, boxes, classes, keypoints (2-dim padded with v = 1)
    and instance masks (rows past max_instances cut)."""
    kw = dict(image_dir=str(yolo_root / "images"),
              label_dir=str(yolo_root / "labels"), image_size=size,
              num_keypoints=K, max_instances=max_inst)
    pd, jd = YoloPoseDataset(**kw), JYolo(**kw)
    assert [os.path.basename(p) for p in pd.image_paths] == \
        [os.path.basename(p) for p in jd.image_paths]
    assert len(pd) == 6 and not any("e." in p for p in pd.image_paths)
    for i in range(len(pd)):
        _assert_items_equal(pd[i], jd[i])
    by = {os.path.basename(p)[0]: i for i, p in enumerate(pd.image_paths)}
    assert pd.labels[by["c"]].shape == (6, 5 + 3 * K)     # all rows kept
    assert pd[by["c"]]["instance_mask"].sum() == min(6, max_inst)
    assert pd[by["d"]]["instance_mask"].sum() == 0        # empty file
    assert pd[by["f"]]["instance_mask"].sum() == 0        # no file
    assert (pd[by["b"]]["keypoints"][:1, :, 2] == 1).all()   # 2-dim: v = 1


LABELS = {
    "three_dim": ("0 0.5 0.5 0.2 0.2 0.4 0.4 2\n1 0.1 0.1 0.1 0.1 0.2 0.2 1\n",
                  8),
    "blank_lines": ("\n0 0.5 0.5 0.2 0.2 0.4 0.4 2   \n\n\n", 8),
    "empty": ("", 8),
    "wrong_count": ("0 0.5 0.5\n", 8),
    "trailing_text": ("0 0.5 0.5 0.2 0.2 0.4 0.4 2 x\n", 8),
    "many_rows": ("".join(f"{i % 3} 0.{i} 0.5 0.2 0.2\n"
                          for i in range(1, 10)), 5),
}


@pytest.mark.parametrize("case", sorted(LABELS) + ["missing"])
def test_parse_yolo_label_matches_jax(tmp_path, io_path, case):
    """parse_yolo_label on each kind of file equals JAX's on the same
    path: rows (all of them, past max_rows 4 too), 0 rows for an empty
    or missing file, None for a malformed one."""
    path = tmp_path / "l.txt"
    cols = 8
    if case != "missing":
        text, cols = LABELS[case]
        path.write_text(text)
    got = p_io.parse_yolo_label(str(path), cols, max_rows=4)
    want = j_io.parse_yolo_label(str(path), cols, max_rows=4)
    if want is None:
        assert got is None
        return
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "many_rows":
        assert got.shape == (9, 5)


def test_decode_jpeg_batch_matches_jax(yolo_root, io_path):
    """decode_jpeg_batch equals JAX's byte for byte on both paths; the
    native path zero-fills a file it cannot read."""
    paths = sorted(str(p) for p in (yolo_root / "images").glob("*.jp*g"))
    got = p_io.decode_jpeg_batch(paths, 40, 56, num_threads=2)
    want = j_io.decode_jpeg_batch(paths, 40, 56, num_threads=2)
    assert got.shape == (len(paths), 40, 56, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if io_path == "native":
        out = p_io.decode_jpeg_batch([str(yolo_root / "nope.jpg")], 8, 8)
        assert (out == 0).all()


def test_native_library_binds_the_new_entry_points():
    """The port's own library (its hash-named build under build/) has
    the YOLO entry points and ABI version 4."""
    if not _have_native():
        pytest.skip("g++ or jpeglib.h missing: no native path here")
    lib = p_io.get_lib()
    assert lib.tp_io_version() == p_io.IO_VERSION == 4
    assert all(hasattr(lib, n) for n in p_io.NEEDED)


def test_builder_yolo_pose_branch(yolo_root):
    """data.name=yolo_pose builds YoloPoseDataset from train_dir /
    valid_dir with the config's size, keypoints and max_instances, and
    its loader batches padded instances."""
    from tpupose_torch.configs import default_config
    from tpupose_torch.engine.builder import Builder

    cfg = default_config()
    cfg.data.name = "yolo_pose"
    cfg.data.train_dir = cfg.data.valid_dir = str(yolo_root)
    cfg.data.image_size = (64, 64)
    cfg.data.max_instances = 5
    cfg.model.num_keypoints = K
    cfg.eval.batch_size = 4
    b = Builder(cfg, device="cpu")
    ds = b.dataset("valid")
    assert isinstance(ds, YoloPoseDataset) and len(ds) == 6
    batch = next(iter(b.dataloader(ds, "valid")))
    assert batch["images"].shape == (4, 64, 64, 3)
    assert batch["keypoints"].shape == (4, 5, K, 3)
    assert batch["instance_mask"].shape == (4, 5)


# --------------------------------------------------------------- MPII


def _write_mpii(root, n=3, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    anns = []
    for i in range(n):
        name = f"img_{i}.jpg"
        arr = rng.randint(0, 255, (H0, W0, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "images", name),
                                  quality=92)
        joints = np.stack([rng.uniform(30, 90, 16),
                           rng.uniform(20, 80, 16)], axis=1)
        anns.append({
            "image": name,
            "center": [61.0, 51.0],          # 1-based (MATLAB)
            "scale": 0.4,                     # an 80 px person box
            "joints": joints.tolist(),
            "joints_vis": [1] * 14 + [0, 1],
        })
    for split in ("train", "valid"):
        with open(os.path.join(root, "annot", f"{split}.json"), "w") as f:
            json.dump(anns, f)
    return anns


def _ds(root, split="valid", **kw):
    return MpiiTopDownDataset(
        image_dir=str(root / "images"),
        ann_file=str(root / "annot" / f"{split}.json"),
        image_size=(64, 64), heatmap_size=(16, 16),
        is_train=(split == "train"), **kw)


def test_parse_conventions(tmp_path):
    anns = _write_mpii(str(tmp_path))
    ds = _ds(tmp_path)
    assert len(ds) == 3
    s = ds.samples[0]
    assert s["center0"][0] == pytest.approx(60.0)
    assert s["center0"][1] == pytest.approx(50.0 + 15 * 0.4)
    assert float(s["scale0"]) == pytest.approx(0.4 * 1.25)
    raw = np.asarray(anns[0]["joints"], np.float32)
    np.testing.assert_allclose(s["joints"], raw - 1.0, atol=1e-5)
    c, sc = ds._center_scale(s)
    assert sc[0] == pytest.approx(0.4 * 1.25 * 200)
    assert sc[0] == pytest.approx(sc[1])


def test_getitem_labels_match_affine(tmp_path):
    from tpupose_torch.ops.affine import get_affine_matrix_np

    _write_mpii(str(tmp_path))
    d = _ds(tmp_path)[1]
    assert d["image"].shape == (64, 64, 3) and d["image"].dtype == np.uint8
    assert d["joints"].shape == (16, 2) and d["visibility"].shape == (16,)
    m = get_affine_matrix_np(d["center"], d["scale"], 0.0, (16, 16))
    inv = np.linalg.inv(m[:, :2])
    expect = (inv @ (d["joints_src"].T - m[:, 2:3])).T
    np.testing.assert_allclose(d["joints"], expect, atol=1e-4)
    assert d["visibility"][14] == 0.0


def test_flip_uses_mpii_pairs(tmp_path):
    _write_mpii(str(tmp_path))
    ds = _ds(tmp_path, "train", scale_factor=0.0, rotation_factor=0.0,
             flip_prob=1.0, seed=3)
    base = ds.samples[0]
    _, center, _, rot, flipped, joints_src, vis = ds._sample_params(0)
    assert flipped and rot == 0.0
    mirrored = base["joints"].copy()
    mirrored[:, 0] = base["width"] - 1 - mirrored[:, 0]
    for a, b in MPII_FLIP_PAIRS:
        mirrored[[a, b]] = mirrored[[b, a]]
    np.testing.assert_allclose(joints_src, mirrored, atol=1e-5)
    assert center[0] == pytest.approx(base["width"] - 1 - base["center0"][0])
    assert vis[11] == 0.0 and vis[14] == 1.0


def _mpii_cfg(root, **over):
    from tpupose_torch.configs import default_config

    cfg = default_config()
    cfg.data.name = "mpii"
    cfg.data.root = str(root)
    cfg.data.image_size = [64, 64]
    cfg.model.name = "simple_baseline"
    cfg.model.backbone = "resnet18"
    cfg.model.num_keypoints = 16
    cfg.model.heatmap_size = [16, 16]
    cfg.model.deconv_channels = [16, 16, 16]
    cfg.train.batch_size = 2
    cfg.eval.batch_size = 2
    cfg.train.mixed_precision = False
    cfg.train.output_dir = str(root / "out")
    cfg.data.num_workers = 0
    for k, v in over.items():
        setattr(getattr(cfg, k.split(".")[0]), k.split(".")[1], v)
    return cfg


def test_batch_and_builder_wiring(tmp_path):
    from tpupose_torch.engine.builder import Builder

    _write_mpii(str(tmp_path))
    b = Builder(_mpii_cfg(tmp_path), device="cpu")
    ds = b.dataset("valid")
    assert isinstance(ds, MpiiTopDownDataset) and not ds.is_train
    batch = next(iter(b.dataloader(ds, "valid")))
    assert batch["images"].shape[1:] == (64, 64, 3)
    assert batch["joints"].shape[1:] == (16, 2)
    assert "joints_src" in batch and "center" in batch


def test_trainer_evaluator_gets_mpii_flip_pairs(tmp_path):
    """The Trainer hands MPII's flip pairs to its evaluator, builds PCKh
    from eval.metrics, and evaluates (flip, DARK) to finite metrics."""
    from tpupose_torch.engine.trainer import Trainer
    from tpupose_torch.metrics.pckh import PCKh

    _write_mpii(str(tmp_path))
    tr = Trainer(_mpii_cfg(tmp_path, **{"eval.metrics": ("pckh", "mpjpe")}),
                 device="cpu")
    ev = tr._get_evaluator()
    np.testing.assert_array_equal(ev.flip_pairs, MPII_FLIP_PAIRS)
    assert any(isinstance(m, PCKh) for m in tr._build_eval_metrics())
    out = tr.evaluate()
    assert {"pckh", "mpjpe"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("split,device_affine,udp,half_body", [
    ("valid", False, False, 0.0), ("train", False, False, 0.0),
    ("train", True, True, 1.0)])
def test_mpii_items_match_jax(tmp_path, io_path, split, device_affine, udp,
                              half_body):
    """MpiiTopDownDataset's items (through get_batch, the loader's path)
    equal JAX's: image bytes, joints, visibility, center, scale, area,
    rotation and flip, with augmentation on the same (seed, sample,
    visit) draws, over two visits."""
    _write_mpii(str(tmp_path), n=4)
    kw = dict(image_dir=str(tmp_path / "images"),
              ann_file=str(tmp_path / "annot" / f"{split}.json"),
              image_size=(64, 48), heatmap_size=(16, 12),
              is_train=(split == "train"), seed=5,
              augment_geometry=not device_affine, udp=udp,
              half_body_prob=half_body)
    pd, jd = MpiiTopDownDataset(**kw), JMpii(**kw)
    for _ in range(2):
        got, want = pd.get_batch([0, 2, 1, 3]), jd.get_batch([0, 2, 1, 3])
        for a, b in zip(got, want):
            _assert_items_equal(a, b)


def test_mpii_trains_on_device_affine(tmp_path):
    """simple_baseline_mpii's recipe at a tiny size: two steps with
    data.device_affine through Trainer (K7's plain version on the CPU),
    finite falling-or-flat losses, then evaluate() with PCKh."""
    from tpupose_torch.engine.trainer import Trainer

    _write_mpii(str(tmp_path), n=4)
    tr = Trainer(_mpii_cfg(tmp_path, **{
        "data.device_affine": True, "train.epochs": 1,
        "eval.metrics": ("pckh", "pck")}), device="cpu")
    loss = tr.iter_one_epoch(0)
    assert tr.state.step == 2 and np.isfinite(loss)
    out = tr.evaluate()
    assert 0.0 <= out["pckh"] <= 1.0
    assert torch.isfinite(next(tr.model.parameters())).all()
