"""Detection-box COCO evaluation in the port (engine/det_eval.py:
DetectionCropDataset, evaluate_detections; Trainer.evaluate with
eval.det_boxes) and the remaining metrics passed to
TopDownEvaluator.run, against the JAX package on the CPU.

The set is tests/test_torch_evaluate.py's COCO-format one (6 images of
1-3 persons, 4 keypoints painted as Gaussian blobs, a crowd
annotation), the same files serving train2017 and val2017; the
detections are seeded: every GT box jittered (one image's twice), one
false positive an image, one below the score threshold, a zero-size box, another
category, an unknown image id, and an image with GT left without any
detection. The model is that file's perfect pool model (heatmaps that
peak at the painted joints) at 128x96; the Trainer runs a random
SimpleBaseline-R18 at 64x64, JAX's weights carried across.

Tolerances: crops bit-equal (both packages' native crop, as in
tests/test_torch_coco.py; the PIL crops within its mean bound of 4 grey
levels); source coordinates within 1e-4 px and scores within 1e-5; every
AP/AR within 1e-6 (the Trainer's random model: 1e-4, as in
tests/test_torch_evaluate.py); results JSON equal.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpupose.data.loader import BatchLoader as JLoader
from tpupose.engine.det_eval import DetectionCropDataset as JDetDataset
from tpupose.engine.det_eval import evaluate_detections as j_evaluate
from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose_torch.data.loader import BatchLoader as PLoader
from tpupose_torch.engine.det_eval import DetectionCropDataset
from tpupose_torch.engine.det_eval import evaluate_detections
from tpupose_torch.engine.evaluator import TopDownEvaluator

from test_torch_evaluate import (K, JPool, PPool, _jstate, _loaders,
                                 _tiny_cfg, coco_root)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

HW, HM = (128, 96), (32, 24)
SIGMAS = np.full(K, 0.08, np.float32)
NO_PAIRS = np.zeros((0, 2), np.int64)


@pytest.fixture(scope="module")
def det_root(coco_root, tmp_path_factory):
    """coco_root with train2017 (the same files) and a seeded detection
    JSON; returns (root, det file)."""
    root = tmp_path_factory.mktemp("det")
    for split in ("train2017", "val2017"):
        shutil.copytree(coco_root / "val2017", root / split)
    (root / "annotations").mkdir()
    ann = json.loads((coco_root / "annotations"
                      / "person_keypoints_val2017.json").read_text())
    for split in ("train2017", "val2017"):
        (root / "annotations" / f"person_keypoints_{split}.json") \
            .write_text(json.dumps(ann))
    rng = np.random.RandomState(3)
    dets = []
    for a in ann["annotations"]:
        if a["image_id"] == 5:                    # GT without detections
            continue
        x, y, w, h = a["bbox"]
        j = rng.uniform(-0.08, 0.08, 4) * [w, h, w, h]
        dets.append({"image_id": a["image_id"], "category_id": 1,
                     "bbox": [x + j[0], y + j[1], w + j[2], h + j[3]],
                     "score": float(rng.uniform(0.5, 1.0))})
        if a["image_id"] == 2:                    # a duplicate, for NMS
            dets.append({**dets[-1], "bbox": [x - j[0], y - j[1], w, h],
                         "score": dets[-1]["score"] - 0.1})
    for i in range(5):
        dets.append({"image_id": i, "category_id": 1,            # false +
                     "bbox": [220.0, 120.0, 60.0, 100.0],
                     "score": float(rng.uniform(0.2, 0.6))})
        dets.append({"image_id": i, "category_id": 1,     # below threshold
                     "bbox": [30.0, 30.0, 80.0, 150.0], "score": 0.01})
    dets += [{"image_id": 0, "category_id": 1, "bbox": [5, 5, 0, 40],
              "score": 0.9},
             {"image_id": 1, "category_id": 2, "bbox": [5, 5, 40, 40],
              "score": 0.9},
             {"image_id": 77, "category_id": 1, "bbox": [5, 5, 40, 40],
              "score": 0.9}]
    det_file = root / "dets.json"
    det_file.write_text(json.dumps(dets))
    return root, str(det_file)


def _datasets(det_root, **kw):
    root, det_file = det_root
    args = dict(image_dir=str(root / "val2017"),
                ann_file=str(root / "annotations"
                             / "person_keypoints_val2017.json"),
                det_file=det_file, image_size=HW, heatmap_size=HM,
                num_keypoints=K, flip_pairs=NO_PAIRS,
                score_threshold=0.05, **kw)
    return JDetDataset(**args), DetectionCropDataset(**args)


@pytest.mark.parametrize("max_per_image", [100, 2])
def test_dataset_matches_jax(det_root, max_per_image):
    """The samples (category filter, score threshold, the per-image cap
    after the descending score sort, zero-size boxes dropped), the GT per
    image (crowd skipped) and each padded batch (crops, centers, scales,
    det_score, image ids) equal JAX's."""
    jd, pd = _datasets(det_root, max_per_image=max_per_image)
    assert len(pd) == len(jd) > 0
    for a, b in zip(pd.samples, jd.samples):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert set(pd.gt_by_image) == set(jd.gt_by_image) == set(range(6))
    for iid, gts in jd.gt_by_image.items():
        assert len(pd.gt_by_image[iid]) == len(gts)
        for g, w in zip(pd.gt_by_image[iid], gts):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
    per_image = {}
    for s in pd.samples:
        per_image.setdefault(s["image_id"], []).append(s["det_score"])
    assert 5 not in per_image
    assert all(len(v) <= max_per_image and v == sorted(v, reverse=True)
               and min(v) >= 0.05 for v in per_image.values())
    lk = dict(batch_size=4, shuffle=False, drop_last=False, pad_last=True)
    for jb, pb in zip(JLoader(jd, **lk), PLoader(pd, **lk)):
        assert sorted(pb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


def test_pil_crops_track_the_native_crops(det_root):
    """The card's host has no jpeglib.h, so there the dataset crops with
    PIL: its crops track the native path's here."""
    _, pd = _datasets(det_root)
    fast = pd.get_batch(np.arange(len(pd)))
    for i, a in enumerate(fast):
        b = pd[i]
        assert a["det_score"] == b["det_score"]
        np.testing.assert_array_equal(a["center"], b["center"])
        diff = np.abs(a["image"].astype(np.float32)
                      - b["image"].astype(np.float32))
        assert diff.mean() < 4.0, diff.mean()


def _evaluators(flip=False):
    v = JPool().init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    kw = dict(flip_test=flip, flip_pairs=NO_PAIRS)
    return (JEvaluator(_jstate(JPool().apply, v), HM, **kw),
            TopDownEvaluator(PPool(), HM, device="cpu", **kw))


@pytest.mark.parametrize("nms", ["oks", "soft_oks", "none"])
def test_evaluate_detections_matches_jax(det_root, tmp_path, nms):
    """Each batch's source coordinates within 1e-4 px of JAX's and its
    scores within 1e-5; the AP suite within 1e-6; the results JSON equal
    (instances, order, rounded keypoints and scores). OKS-NMS removes
    duplicates ("none" keeps every detection)."""
    jd, pd = _datasets(det_root)
    jev, pev = _evaluators()
    lk = dict(batch_size=4, shuffle=False, drop_last=False, pad_last=True)
    for jb, pb in zip(JLoader(jd, **lk), PLoader(pd, **lk)):
        wc, ws = jev.step(jb["images"], jb["center"], jb["scale"])
        gc, gs = pev.step(pb["images"], pb["center"], pb["scale"])
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-7)
    kw = dict(batch_size=4, sigmas=SIGMAS, num_workers=0, nms=nms,
              nms_threshold=0.5)
    want = j_evaluate(jev, jd, results_path=str(tmp_path / "j.json"), **kw)
    got = evaluate_detections(pev, pd, results_path=str(tmp_path / "p.json"),
                              **kw)
    assert sorted(got) == sorted(want)
    assert {"mAP", "mAP50", "mAP75", "AR"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-6, (k, got[k], w)
    assert got["mAP50"] > 0.5
    jr, pr = (json.loads((tmp_path / f).read_text())
              for f in ("j.json", "p.json"))
    assert pr == jr
    if nms == "none":
        assert len(pr) == len(pd)
    elif nms == "oks":
        assert len(pr) < len(pd)


def test_evaluate_detections_fetches_two_batches_in_flight(det_root,
                                                           monkeypatch):
    """As TopDownEvaluator.run: batch i's result is read only after
    batch i+2 was dispatched, in the loader's order."""
    _, pd = _datasets(det_root)
    _, pev = _evaluators()
    events = []
    real_step, real_fetch = pev.step, pev._fetch

    def step(*a):
        events.append("step")
        return real_step(*a)

    class Host:
        def __init__(self, t):
            self.t = t

        def numpy(self):
            events.append("read")
            return self.t.numpy()

    monkeypatch.setattr(pev, "step", step)
    monkeypatch.setattr(pev, "_fetch", lambda c, s: (
        Host(real_fetch(c, s)[0]), None))
    evaluate_detections(pev, pd, batch_size=4, sigmas=SIGMAS, num_workers=0)
    n = -(-len(pd) // 4)
    assert n >= 3
    assert events == ["step"] * 3 + ["read", "step"] * (n - 3) \
        + ["read"] * 3


def test_pdj_and_pcp_through_the_evaluator_match_jax(coco_root):
    """PDJ and PCP (and PCPm) handed to TopDownEvaluator.run beside PCK,
    on the perfect pool model over the GT-box set: equal to JAX's run
    within 1e-6."""
    import tpupose.metrics as J
    import tpupose_torch.metrics as P

    jl, pl = _loaders(coco_root, HW, HM)
    jev, pev = _evaluators(flip=True)

    def metrics(M):
        return [M.PCK(alpha=0.2), M.PDJ(alpha=0.1, torso_indices=(0, 2)),
                M.PCP(alpha=0.5, limbs=((0, 1), (1, 2), (2, 3))),
                M.PCPm(alpha=0.5, limbs=((0, 1), (1, 2), (2, 3)))]

    want = jev.run(jl, metrics(J))
    got = pev.run(pl, metrics(P))
    assert sorted(got) == sorted(want) and {"pdj", "pcp", "pcpm"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-6, (k, got[k], w)
    assert got["pdj"] > 0.5 and got["pcp"] > 0.5


@pytest.fixture(scope="module")
def trainers(det_root, tmp_path_factory):
    """JAX's Trainer and the port's on the COCO-format set with
    eval.det_boxes, the JAX weights carried into the port."""
    from tpupose.engine.trainer import Trainer as JTrainer
    from tpupose_torch.engine.trainer import Trainer as PTrainer
    from tpupose_torch.utils.convert import from_flax_simple_baseline

    root, det_file = det_root
    tmp = tmp_path_factory.mktemp("det_tr")
    over = {"data.name": "coco", "data.root": str(root),
            "eval.det_boxes": det_file, "eval.batch_size": 8,
            "eval.det_score_threshold": 0.05, "eval.metrics": ("pck",),
            "eval.flip_test": False}      # COCO's 17-joint pairs; K = 4
    jt = JTrainer(_tiny_cfg("tpupose", tmp, **over))
    pt = PTrainer(_tiny_cfg("tpupose_torch", tmp, **over), device="cpu")
    v = {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}
    pt.model.load_state_dict(from_flax_simple_baseline(v))
    return jt, pt


def test_trainer_evaluate_with_det_boxes_matches_jax(trainers):
    """Trainer.evaluate with eval.det_boxes: the GT-box metrics and the
    det_* suite of the same evaluator, within 1e-4 of JAX's (a random
    R18: DARK on flat heatmaps, see tests/test_torch_evaluate.py)."""
    jt, pt = trainers
    want, got = jt.evaluate(), pt.evaluate()
    assert sorted(got) == sorted(want)
    assert {"pck", "det_mAP", "det_mAP50", "det_AR"} <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
