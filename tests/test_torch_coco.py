"""The port's COCO top-down data path (tpupose_torch/data/coco.py,
data/native_io.py with its own copy of the native runtime, the loader's
batched get_batch path and the builder's coco branch) against the JAX
package's, on a COCO-format set written to a temporary directory.

Tolerances: image bytes equal (PIL path of both packages, native path of
both packages); joints, visibility, center, scale, area and the Gaussian
targets rendered from the joints within 1e-5. The port's native crops
against its own PIL crops: mean absolute difference below 4 (the bound
of tests/test_native_io.py: the two decode at different DCT scales and
interpolate differently).
"""

import json
import shutil

import numpy as np
import pytest
import torch

from tpupose.data.coco import CocoTopDownDataset as JCoco
from tpupose.data.loader import BatchLoader as JLoader
from tpupose_torch.data.coco import CocoTopDownDataset as PCoco
from tpupose_torch.data.loader import BatchLoader as PLoader

LABEL_KEYS = ("joints", "joints_src", "visibility", "center", "scale",
              "area", "rotation", "image_id", "flipped")


def _have_native():
    from pathlib import Path

    return bool(shutil.which("g++")) and Path(
        "/usr/include/jpeglib.h").exists()


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """5 JPEGs (smooth gradients plus noise) with 1-3 persons each, 17
    keypoints partly invisible; one crowd annotation and one with no
    labelled keypoint, which the dataset skips. The same annotations
    serve train2017 and val2017."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco_port")
    (root / "annotations").mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(5):
        H0, W0 = 280 + 20 * i, 320
        yy, xx = np.mgrid[0:H0, 0:W0].astype(np.float32)
        img = np.stack([xx * 255 / W0, yy * 255 / H0,
                        (xx + yy) * 127 / (W0 + H0)], -1)
        img = np.clip(img + rng.uniform(0, 12, img.shape), 0, 255)
        name = f"{i:012d}.jpg"
        for split in ("train2017", "val2017"):
            (root / split).mkdir(exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(root / split / name,
                                                       quality=95)
        images.append({"id": i, "file_name": name, "width": W0,
                       "height": H0})
        for p in range(1 + i % 3):
            x, y = rng.uniform(5, 120), rng.uniform(5, 80)
            w, h = rng.uniform(60, 180), rng.uniform(100, 190)
            kp = np.stack([rng.uniform(x, x + w, 17),
                           rng.uniform(y, y + h, 17),
                           rng.choice([0, 1, 2], 17, p=[0.2, 0.3, 0.5])], 1)
            kp[kp[:, 2] == 0, :2] = 0
            anns.append({"id": len(anns), "image_id": i, "category_id": 1,
                         "bbox": [x, y, w, h],
                         "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": int((kp[:, 2] > 0).sum()),
                         "area": float(w * h * 0.7), "iscrowd": 0})
    anns[1]["iscrowd"] = 1
    anns[2]["num_keypoints"] = 0
    for split in ("train2017", "val2017"):
        with open(root / "annotations" / f"person_keypoints_{split}.json",
                  "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return root


def _pair(root, split="train2017", **kw):
    args = dict(image_dir=str(root / split),
                ann_file=str(root / "annotations"
                             / f"person_keypoints_{split}.json"),
                image_size=(128, 96), heatmap_size=(32, 24),
                is_train=split == "train2017", seed=5)
    args.update(kw)
    return JCoco(**args), PCoco(**args)


def _assert_item(got, want, images_equal=True):
    for k in LABEL_KEYS:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=0, atol=1e-5, err_msg=k)
    if images_equal:
        np.testing.assert_array_equal(got["image"], want["image"])


def _targets(batch, gauss):
    return gauss(batch["joints"], batch["visibility"], (32, 24), 2.0)


@pytest.mark.parametrize("split,half_body,udp", [
    ("val2017", 0.0, False), ("val2017", 0.0, True),
    ("train2017", 0.0, False), ("train2017", 1.0, False),
    ("train2017", 1.0, True)])
def test_items_match_jax_on_the_pil_path(coco_root, split, half_body, udp):
    """Two visits of every sample (the per-(seed, sample, visit) draws,
    half-body among them): the same crops, flips and labels, and the
    same Gaussian targets rendered from the joints."""
    from tpupose.ops.heatmap import gaussian_heatmaps as j_gauss
    from tpupose_torch.ops.heatmap import gaussian_heatmaps as p_gauss

    jd, pd = _pair(coco_root, split, half_body_prob=half_body, udp=udp,
                   half_body_min_joints=3)
    assert len(pd) == len(jd) == 7            # 9 annotations, 2 skipped
    flips = set()
    for visit in range(2):
        for i in range(len(pd)):
            want, got = jd[i], pd[i]
            _assert_item(got, want)
            flips.add(bool(got["flipped"]))
            jt, jw = j_gauss(want["joints"][None], want["visibility"][None],
                             (32, 24), 2.0)
            pt, pw = p_gauss(torch.from_numpy(got["joints"][None]),
                             torch.from_numpy(got["visibility"][None]),
                             (32, 24), 2.0)
            np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5)
            np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-5)
    if split == "train2017":
        assert flips == {True, False}


@pytest.mark.skipif(not _have_native(), reason="g++ or jpeglib.h absent")
def test_native_library_is_the_ports_own_build():
    from tpupose_torch.data import native_io

    assert native_io.get_lib() is not None
    so = native_io._so_path()
    assert so.exists() and "build" in so.parts and "tpupose_torch" in so.parts
    assert not list(native_io.NATIVE_DIR.glob("*.so"))


@pytest.mark.skipif(not _have_native(), reason="g++ or jpeglib.h absent")
@pytest.mark.parametrize("mode", ["fused", "cached"])
def test_native_batches_equal_jax_bytes(coco_root, mode):
    """decode_warp_batch (and the decode-once / warp-per-epoch cache
    path, twice so the second batch hits the cache) of the port's
    library gives the JAX package's library's bytes exactly."""
    from tpupose.data import native_io as jn
    from tpupose_torch.data import native_io as pn

    if jn.get_lib() is None:
        pytest.skip("the JAX package's native library does not build")
    cache = 64 if mode == "cached" else 0
    jd, pd = _pair(coco_root, decode_cache_mb=cache)
    idx = np.arange(len(pd))
    for _ in range(2):
        for got, want in zip(pd.get_batch(idx), jd.get_batch(idx)):
            _assert_item(got, want)
    if mode == "fused":
        mats = np.stack([pd._flip_folded_matrix(*pd._sample_params(i)[:5])
                         for i in range(3)])
        paths = [str(coco_root / "train2017" / s["file_name"])
                 for s in pd.samples[:3]] + [str(coco_root / "missing.jpg")]
        mats = np.concatenate([mats, mats[:1]])
        (pi, pok), (ji, jok) = (pn.decode_warp_batch(paths, mats, 64, 48),
                                jn.decode_warp_batch(paths, mats, 64, 48))
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pok, jok)
        assert pok.tolist() == [True, True, True, False]


@pytest.mark.skipif(not _have_native(), reason="g++ or jpeglib.h absent")
def test_native_crops_track_the_pil_crops(coco_root):
    _, pd = _pair(coco_root, "val2017")
    fast = pd.get_batch(np.arange(len(pd)))
    for i, a in enumerate(fast):
        b = pd[i]
        _assert_item(a, b, images_equal=False)
        diff = np.abs(a["image"].astype(np.float32)
                      - b["image"].astype(np.float32))
        assert diff.mean() < 4.0, diff.mean()


def test_get_batch_without_the_native_library_takes_pil(coco_root,
                                                        monkeypatch):
    """Where the library does not build, get_batch crops with PIL from
    the params it already drew (the draws do not advance twice)."""
    from tpupose_torch.data import native_io

    monkeypatch.setattr(native_io, "get_lib", lambda: None)
    jd, pd = _pair(coco_root)
    for got, i in zip(pd.get_batch([3, 0, 5]), (3, 0, 5)):
        _assert_item(got, jd[i])
    assert pd._visits == {3: 1, 0: 1, 5: 1}


def test_loader_takes_get_batch_and_matches_jax(coco_root, monkeypatch):
    """The port's BatchLoader calls the dataset's get_batch (the batched
    path) and gives the JAX loader's batches: shuffled train batches and
    padded eval batches with their pad_mask."""
    jd, pd = _pair(coco_root)
    calls = []
    real = pd.get_batch
    monkeypatch.setattr(pd, "get_batch",
                        lambda idx: calls.append(len(idx)) or real(idx))
    for jl, pl in ((JLoader(jd, 3, shuffle=True, seed=2),
                    PLoader(pd, 3, shuffle=True, seed=2)),
                   (JLoader(jd, 3, shuffle=False, drop_last=False,
                            pad_last=True),
                    PLoader(pd, 3, shuffle=False, drop_last=False,
                            pad_last=True))):
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) > 0
        for a, b in zip(pb, jb):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                           np.asarray(b[k], np.float64),
                                           atol=1e-5, err_msg=k)
    assert calls == [3, 3, 3, 3, 3]


def test_builder_coco_branch(coco_root):
    """data.name=coco builds the port's CocoTopDownDataset with the
    config's knobs; a name no dataset has raises (the mpii and yolo_pose
    branches are held in tests/test_torch_mpii_yolo.py)."""
    from tpupose_torch.configs import default_config
    from tpupose_torch.engine.builder import Builder

    cfg = default_config()
    cfg.data.name = "coco"
    cfg.data.root = str(coco_root)
    cfg.data.image_size = (128, 96)
    cfg.model.heatmap_size = (32, 24)
    cfg.data.half_body_prob = 0.3
    cfg.data.device_affine = True
    cfg.data.udp = True
    cfg.eval.batch_size = 4
    b = Builder(cfg, device="cpu")
    tr, va = b.dataset("train"), b.dataset("valid")
    assert isinstance(tr, PCoco) and isinstance(va, PCoco)
    assert tr.is_train and not va.is_train
    assert tr.half_body_prob == 0.3 and tr.udp and not tr.augment_geometry
    assert va.image_dir.endswith("val2017")
    loader = b.dataloader(va, "valid")
    batch = next(iter(loader))
    assert batch["images"].shape == (4, 128, 96, 3)
    assert batch["pad_mask"].all()
    cfg.data.name = "cocoo"
    with pytest.raises(ValueError, match="unknown dataset 'cocoo'"):
        Builder(cfg, device="cpu").dataset("train")
