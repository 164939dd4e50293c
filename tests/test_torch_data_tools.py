"""The port's data tools (tpupose_torch/cli/tools.py: check-data,
check-labels, resize, convert-coco) against the JAX package's
(tpupose/cli/tools.py) on a COCO-format set the tests write, and the
port's own copies of the method configs. The two convert-coco tests are
the twins of tests/test_tools_convert.py.

Tolerances: files equal byte for byte (label text, resized and rendered
images, the method yamls), and the bad-label reports equal.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tpupose.cli import tools as jtools
from tpupose_torch.cli import tools
from tpupose_torch.data.yolo_pose import YoloPoseDataset

from torch_threads import one_torch_thread  # noqa: F401

K = 4
ROOT = Path(__file__).resolve().parents[1]
JAX_METHODS = sorted((ROOT / "tpupose" / "configs" / "method").glob("*.yaml"))


def _coco(tmp_path, K=K):
    (tmp_path / "images").mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    aid = 0
    for i in range(3):
        W0, H0 = 320, 240
        name = f"img_{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (H0, W0, 3)).astype(np.uint8)
                        ).save(tmp_path / "images" / name)
        images.append({"id": i, "file_name": name, "width": W0,
                       "height": H0})
        for p in range(1 + i % 2):
            x, y, w, h = 30.0 + 90 * p, 40.0, 80.0, 120.0
            kp = []
            for k in range(K):
                kp += [x + 10 + 12 * k, y + 15 + 20 * k, 2]
            anns.append({"id": aid, "image_id": i, "category_id": 1,
                         "bbox": [x, y, w, h], "keypoints": kp,
                         "num_keypoints": K, "area": w * h, "iscrowd": 0})
            aid += 1
    # one crowd and one keypointless annotation, both skipped
    anns.append({"id": aid, "image_id": 0, "category_id": 1,
                 "bbox": [0, 0, 10, 10], "keypoints": [0, 0, 0] * K,
                 "num_keypoints": 0, "area": 100, "iscrowd": 1})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(ann), K


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def test_convert_coco_roundtrip(tmp_path):
    ann, K = _coco(tmp_path)
    out = str(tmp_path / "labels")
    assert tools.main(["convert-coco", "--ann", ann, "--out", out]) == 0
    files = sorted(os.listdir(out))
    assert files == ["img_0.txt", "img_1.txt", "img_2.txt"]
    assert len(open(os.path.join(out, "img_1.txt")).readlines()) == 2
    assert len(open(os.path.join(out, "img_0.txt")).readlines()) == 1

    ds = YoloPoseDataset(image_dir=str(tmp_path / "images"), label_dir=out,
                         num_keypoints=K, image_size=(64, 64),
                         max_instances=4)
    assert len(ds) == 3
    d = ds[1]
    m = d["instance_mask"].astype(bool)
    assert m.sum() == 2
    got = sorted(np.round(d["boxes"][m][:, 0], 4))
    assert got == [round(70 / 320, 4), round(160 / 320, 4)]
    kx = d["keypoints"][m][0, 0, 0]
    assert abs(kx - (30 + 10) / 320) < 1e-4 or abs(kx - (120 + 10) / 320) < 1e-4
    assert (d["keypoints"][m][:, :, 2] == 2).all()


def test_convert_coco_visibility_preserved(tmp_path):
    ann, K = _coco(tmp_path)
    data = json.loads(open(ann).read())
    data["annotations"][0]["keypoints"][2] = 1     # occluded joint
    data["annotations"][0]["keypoints"][5] = 0     # unlabelled joint
    open(ann, "w").write(json.dumps(data))
    out = str(tmp_path / "labels2")
    tools.convert_coco(ann, out)
    rows = np.loadtxt(os.path.join(out, "img_0.txt"), ndmin=2)
    assert rows.shape[1] == 5 + 3 * K
    assert rows[0, 7] == 1.0
    assert rows[0, 10] == 0.0


@pytest.mark.parametrize("min_kpts", [1, 3])
def test_convert_coco_equals_jax(tmp_path, min_kpts):
    """convert-coco writes the same label files, byte for byte, as JAX's,
    with a second category and partly labelled instances."""
    ann, _ = _coco(tmp_path)
    data = json.loads(open(ann).read())
    data["annotations"][1]["category_id"] = 2
    data["annotations"][2]["keypoints"][2::3] = [0, 0, 1, 2]
    open(ann, "w").write(json.dumps(data))
    tools.main(["convert-coco", "--ann", ann, "--out",
                str(tmp_path / "p"), "--min-keypoints", str(min_kpts)])
    jtools.main(["convert-coco", "--ann", ann, "--out",
                 str(tmp_path / "j"), "--min-keypoints", str(min_kpts)])
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


def _bad_labels(tmp_path):
    ann, _ = _coco(tmp_path)
    lab = tmp_path / "labels"
    tools.convert_coco(ann, str(lab))
    (lab / "img_1.txt").write_text("0 0.5 0.5 0.1\n")          # 4 columns
    two_dim = " ".join(["0"] + ["0.5"] * (4 + 2 * K))
    (lab / "img_2.txt").write_text(two_dim + "\n\n" + two_dim + " 1\n")
    return lab


@pytest.mark.parametrize("delete", [False, True])
def test_check_labels_equals_jax(tmp_path, delete):
    """check-labels reports the same files, lines and column counts as
    JAX's; a dry run touches nothing, --delete removes each bad label
    and its image, in both packages alike."""
    res = {}
    for name, mod in (("p", tools), ("j", jtools)):
        root = tmp_path / name
        root.mkdir()
        lab = _bad_labels(root)
        bad = mod.check_labels(str(lab), K, delete=delete,
                               images=str(root / "images"))
        res[name] = ([(os.path.basename(p), ln, n) for p, ln, n in bad],
                     sorted(os.listdir(lab)),
                     sorted(os.listdir(root / "images")))
    assert res["p"] == res["j"]
    assert res["p"][0] == [("img_1.txt", 1, 4), ("img_2.txt", 3, 14)]
    n_left = 1 if delete else 3
    assert len(res["p"][1]) == n_left and len(res["p"][2]) == n_left


def test_check_labels_cli_dry_run_keeps_files(tmp_path):
    lab = _bad_labels(tmp_path)
    assert tools.main(["check-labels", "--labels", str(lab), "--nkpts",
                       str(K), "--images", str(tmp_path / "images")]) == 0
    assert len(os.listdir(lab)) == 3


@pytest.mark.parametrize("size", [64, 48])
def test_resize_equals_jax(tmp_path, size):
    """resize writes the same files, byte for byte, as JAX's (a png among
    the jpgs), from a pool of two threads."""
    _coco(tmp_path)
    Image.fromarray(np.full((30, 50, 3), 90, np.uint8)).save(
        tmp_path / "images" / "flat.png")
    assert tools.main(["resize", "--images", str(tmp_path / "images"),
                       "--out", str(tmp_path / "p"), "--size", str(size),
                       "--workers", "2"]) == 0
    jtools.resize_images(str(tmp_path / "images"), str(tmp_path / "j"),
                         size, 2)
    got = _files(tmp_path / "p")
    assert len(got) == 4 and got == _files(tmp_path / "j")
    with Image.open(tmp_path / "p" / "flat.png") as im:
        assert im.size == (size, size)


def test_check_data_equals_jax(tmp_path):
    """check-data renders the same images, byte for byte, as JAX's: the
    labelled keypoints and box corners drawn, an image without a label
    file and one with a malformed label skipped."""
    ann, _ = _coco(tmp_path)
    lab = tmp_path / "labels"
    tools.convert_coco(ann, str(lab))
    (lab / "img_2.txt").write_text("0 0.5 0.5 0.1 0.1\n")     # malformed
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(
        tmp_path / "images" / "nolabel.png")
    assert tools.main(["check-data", "--images", str(tmp_path / "images"),
                       "--labels", str(lab), "--out", str(tmp_path / "p"),
                       "--nkpts", str(K)]) == 0
    jtools.check_data(str(tmp_path / "images"), str(lab),
                      str(tmp_path / "j"), K)
    got = _files(tmp_path / "p")
    assert sorted(got) == ["img_0.jpg", "img_1.jpg"]
    assert got == _files(tmp_path / "j")
    src = np.asarray(Image.open(tmp_path / "images" / "img_0.jpg"))
    drawn = np.asarray(Image.open(tmp_path / "p" / "img_0.jpg"))
    assert np.abs(drawn.astype(int) - src.astype(int)).max() > 100


def test_port_has_every_method_config():
    """The port keeps its own copy of each of the JAX package's 13 method
    configs, and no other."""
    port = sorted((ROOT / "tpupose_torch" / "configs" / "method")
                  .glob("*.yaml"))
    assert [p.name for p in port] == [p.name for p in JAX_METHODS]
    assert len(port) == 13


@pytest.mark.parametrize("jax_yaml", JAX_METHODS, ids=lambda p: p.stem)
def test_port_method_config_equals_jax(jax_yaml):
    """Each port method yaml is byte-equal to the JAX package's and loads
    into the port's config."""
    from tpupose_torch.configs import load_config

    port = ROOT / "tpupose_torch" / "configs" / "method" / jax_yaml.name
    assert port.read_bytes() == jax_yaml.read_bytes()
    assert load_config(str(port)).model.name
