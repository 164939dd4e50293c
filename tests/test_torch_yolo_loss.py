"""The single-stage (YOLO-pose) training pieces of tpupose_torch held
against the JAX package on the CPU, float32, on numpy-seeded inputs:
losses/bbox.py (kpts_to_box, ciou, pairwise_iou_xyxy), losses/classify.py,
losses/keypoint.py (every KPT_LOSSES entry), ComputeLoss, the
TaskAlignedAssigner (with a constructed tie), v8PoseLoss /
v8DetectionLoss at reg_max 16, dfl_loss, the mosaic (given JAX's draws),
SyntheticYoloPoseDataset and OKS-NMS.

Tolerances, with their reasons:
  - elementwise geometry and classification losses: 1e-6 of the compared
    tensor's max |value| (a few float32 operations; transcendental
    functions round differently in the last bit);
  - composite losses (ComputeLoss, the v8 losses, the keypoint family)
    and every gradient: 1e-5 of the max |value| (sums over cells and
    instances in another order);
  - the assigner's discrete outputs (labels, fg mask, assigned GT) and
    OKS-NMS's kept indices: equal; its scores 1e-6;
  - the mosaic: images, classes, masks and `dropped` equal; boxes and
    keypoints equal (the same float32 operations in the same order on
    JAX's draws, JAX run op by op);
  - the synthetic set: bit-equal (the same numpy code on the same
    RandomState).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.data.synthetic import SyntheticYoloPoseDataset as JSynthYolo
from tpupose.losses import bbox as jbbox
from tpupose.losses import classify as jcls
from tpupose.losses import keypoint as jkpt
from tpupose.losses.assigner import TaskAlignedAssigner as JTAL
from tpupose.losses.pose_loss import ComputeLoss as JComputeLoss
from tpupose.losses.v8 import dfl_loss as j_dfl_loss
from tpupose.losses.v8 import v8DetectionLoss as Jv8Det
from tpupose.losses.v8 import v8PoseLoss as Jv8Pose
from tpupose.ops import mosaic as jmosaic
from tpupose.ops import oks_nms as joks
from tpupose_torch import losses as tl
from tpupose_torch.data.synthetic import SyntheticYoloPoseDataset
from tpupose_torch.ops import mosaic as tmosaic
from tpupose_torch.ops import oks_nms as toks

from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"max err {err:.3g} of max |want| (tol {rel})"


def _leaf(a):
    return T(np.array(a, np.float32)).requires_grad_()


# -- losses/bbox.py ------------------------------------------------------------

def _kpt_case(n=16, K=12, seed=0):
    """Keypoints with 0, 1, 2, 4, 5 and up to 12 visible joints."""
    rs = np.random.RandomState(seed)
    kp = rs.uniform(-5, 40, (n, K, 2)).astype(np.float32)
    vis = np.zeros((n, K), np.float32)
    for i in range(n):
        vis[i, rs.permutation(K)[:[0, 1, 2, 4, 5, 8, 12][i % 7]]] = 2.0
    return kp, vis


def test_kpts_to_box_matches_jax():
    kp, vis = _kpt_case()
    want = np.asarray(jbbox.kpts_to_box(jnp.asarray(kp), jnp.asarray(vis)))
    got = tl.kpts_to_box(T(kp), T(vis)).numpy()
    _close(got, want, 1e-6)
    # the box gradient w.r.t. the keypoints selects the same joints
    w = np.random.RandomState(1).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda k: jnp.sum(jbbox.kpts_to_box(k, vis) * w))(
        jnp.asarray(kp))
    tk = _leaf(kp)
    (tl.kpts_to_box(tk, T(vis)) * T(w)).sum().backward()
    _close(tk.grad.numpy(), jg, 1e-6)


def _boxes(n, seed):
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.uniform(0, 20, (n, 2)),
                           rs.uniform(0.5, 12, (n, 2))], -1).astype(np.float32)


def test_ciou_values_and_gradients_match_jax():
    """CIoU of 64 box pairs (overlapping, apart, nested) and its gradient
    w.r.t. both boxes; the aspect term's alpha carries none in either."""
    b1, b2 = _boxes(64, 2), _boxes(64, 3)
    b2[:16] = b1[:16] + 0.3                      # strongly overlapping
    w = np.random.RandomState(4).normal(size=64).astype(np.float32)
    want = np.asarray(jbbox.ciou(b1, b2))
    jg1, jg2 = jax.grad(lambda a, b: jnp.sum(jbbox.ciou(a, b) * w),
                        argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = _leaf(b1), _leaf(b2)
    got = tl.ciou(t1, t2)
    (got * T(w)).sum().backward()
    _close(got.detach().numpy(), want, 1e-6)
    _close(t1.grad.numpy(), jg1, 1e-5)
    _close(t2.grad.numpy(), jg2, 1e-5)


def test_pairwise_iou_and_converters_match_jax():
    a = np.array(jbbox.xywh2xyxy(_boxes(2 * 5, 5).reshape(2, 5, 4)))
    b = np.array(jbbox.xywh2xyxy(_boxes(2 * 7, 6).reshape(2, 7, 4)))
    _close(tl.pairwise_iou_xyxy(T(a), T(b)).numpy(),
           jbbox.pairwise_iou_xyxy(a, b), 1e-6)
    _close(tl.xyxy2xywh(T(a)).numpy(), jbbox.xyxy2xywh(a), 1e-6)


# -- losses/classify.py --------------------------------------------------------

def _cls_case():
    rs = np.random.RandomState(7)
    logits = rs.normal(0, 3, (6, 5)).astype(np.float32)
    score = rs.uniform(0, 1, (6, 5)).astype(np.float32)
    mask = (rs.uniform(size=(6, 5)) > 0.6).astype(np.float32)
    labels = rs.randint(0, 5, 6).astype(np.int32)
    return logits, score, mask, labels


CLS_FNS = {
    "bce": (lambda m, x, s, k, y: m.binary_cross_entropy_with_logits(x, s)),
    "varifocal": (lambda m, x, s, k, y: m.varifocal_loss(x, s * k, k)),
    "focal": (lambda m, x, s, k, y: m.focal_loss(x, k)),
    "multiclass_focal": (lambda m, x, s, k, y: m.multiclass_focal_loss(
        x, y, alpha=[0.1, 0.2, 0.3, 0.4, 0.5])),
    "cross_entropy": (lambda m, x, s, k, y: m.cross_entropy(
        x, y, label_smoothing=0.1)),
}


@pytest.mark.parametrize("name", list(CLS_FNS))
def test_classification_losses_match_jax(name):
    """Values and the gradient of a weighted sum w.r.t. the logits."""
    fn = CLS_FNS[name]
    x, s, k, y = _cls_case()
    want = np.asarray(fn(jcls, jnp.asarray(x), s, k, jnp.asarray(y)))
    w = np.random.RandomState(8).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(fn(jcls, a, s, k, jnp.asarray(y)) * w))(
        jnp.asarray(x))
    tx = _leaf(x)
    got = fn(tl, tx, T(s), T(k), T(y))
    (got * T(w)).sum().backward()
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want, 1e-6)
    _close(tx.grad.numpy(), jg, 1e-5)


# -- losses/keypoint.py --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tl.KPT_LOSSES))
def test_keypoint_losses_match_jax(name):
    """Every KPT_LOSSES entry on (3, 4, K=5) instances: values and the
    gradient w.r.t. the predicted keypoints."""
    rs = np.random.RandomState(9)
    pred = rs.uniform(0, 8, (3, 4, 5, 2)).astype(np.float32)
    tgt = (pred + rs.normal(0, 1.0, pred.shape)).astype(np.float32)
    vis = (rs.uniform(size=(3, 4, 5)) > 0.3).astype(np.float32)
    area = rs.uniform(4, 60, (3, 4)).astype(np.float32)
    jfn, tfn = jkpt.get_kpt_loss(name), tl.get_kpt_loss(name)
    w = rs.normal(size=(3, 4)).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(pred), tgt, vis, area))
    jg = jax.grad(lambda p: jnp.sum(jfn(p, tgt, vis, area) * w))(
        jnp.asarray(pred))
    tp = _leaf(pred)
    got = tfn(tp, T(tgt), T(vis), T(area))
    (got * T(w)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5)
    _close(tp.grad.numpy(), jg, 1e-5)
    with pytest.raises(ValueError):
        tl.get_kpt_loss("nope")


# -- ComputeLoss -----------------------------------------------------------------

B, M, K, NC = 3, 5, 4, 3
GRIDS = [(8, 8), (4, 4), (2, 2)]


def _yolo_targets(seed=10):
    """3 images, M = 5 slots: image 0 has 4 instances, two of them with
    the same class and centre (one cell at every scale, different
    boxes), image 1 has 2, image 2 has 1 and is a padding row
    (sample_mask 0, as Trainer.validate's tail batch makes it)."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((B, M, 4), np.float32)
    cls = np.zeros((B, M), np.int32)
    kpts = np.zeros((B, M, K, 3), np.float32)
    mask = np.zeros((B, M), bool)
    for b, n in enumerate((4, 2, 1)):
        for i in range(n):
            cx, cy = rs.uniform(0.2, 0.8, 2)
            w, h = rs.uniform(0.15, 0.4, 2)
            if b == 0 and i == 1:                # shares instance 0's cell
                cx, cy = boxes[0, 0, :2]
                w, h = boxes[0, 0, 2:] * 1.2
                cls[b, i] = cls[0, 0]
            else:
                cls[b, i] = rs.randint(NC)
            boxes[b, i] = (cx, cy, w, h)
            kpts[b, i, :, 0] = cx + rs.uniform(-w / 2, w / 2, K)
            kpts[b, i, :, 1] = cy + rs.uniform(-h / 2, h / 2, K)
            kpts[b, i, :, 2] = np.where(rs.uniform(size=K) > 0.2, 2.0, 0.0)
            mask[b, i] = True
    return {"boxes": boxes, "classes": cls, "keypoints": kpts,
            "instance_mask": mask,
            "sample_mask": np.array([1, 1, 0], np.float32)}


def _compute_loss_preds(targets, seed=11):
    """Per-scale raw maps (B, H, W, nc + 3K): noise, with each instance's
    centre cell predicting its keypoints up to noise, so that the CIoU
    quality targets are positive (and differ between the two instances
    that share a cell)."""
    rs = np.random.RandomState(seed)
    preds = []
    for (h, w) in GRIDS:
        p = rs.normal(0, 1, (B, h, w, NC + 3 * K)).astype(np.float32)
        for b in range(B):
            for i in range(M):
                if not targets["instance_mask"][b, i]:
                    continue
                cx, cy = targets["boxes"][b, i, :2] * (w, h)
                gx, gy = int(cx), int(cy)
                off = targets["keypoints"][b, i, :, :2] * (w, h) - (gx, gy)
                p[b, gy, gx, NC:].reshape(K, 3)[:, :2] = \
                    off + rs.normal(0, 0.05, (K, 2))
        preds.append(p)
    return preds


@pytest.mark.parametrize("varifocal", [True, False], ids=["vfl", "bce"])
@pytest.mark.parametrize("kpt_loss", ["oks", "hybrid"])
def test_compute_loss_values_and_gradients_match_jax(kpt_loss, varifocal):
    """ComputeLoss: total, every part and the gradient w.r.t. each
    per-scale map, with padded instances, a zero sample_mask row and two
    instances in one cell (the quality scatter keeps the larger score)."""
    tg = _yolo_targets()
    preds = _compute_loss_preds(tg)
    kw = dict(num_keypoints=K, num_classes=NC, kpt_loss_type=kpt_loss,
              use_varifocal=varifocal)
    jloss = JComputeLoss(**kw)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    (jtotal, jparts), jg = jax.value_and_grad(
        lambda ps: jloss(ps, jt), has_aux=True)([jnp.asarray(p)
                                                  for p in preds])
    tp = [_leaf(p) for p in preds]
    total, parts = tl.ComputeLoss(**kw)(tp, {k: T(v) for k, v in tg.items()})
    total.backward()
    _close(total.item(), float(jtotal), 1e-5)
    assert set(parts) == set(jparts) == {"cls", "kpt", "vis"}
    for k in parts:
        _close(parts[k].item(), float(jparts[k]), 1e-5)
    for p, g in zip(tp, jg):
        _close(p.grad.numpy(), g, 1e-5)


def test_compute_loss_shared_cell_keeps_the_larger_quality():
    """The two instances of image 0 that share a cell and class get
    different positive qualities; the class target there is the larger
    (JAX's .at[].max()): the summed class loss with both instances equals
    the one without the lower-quality instance (rel 1e-6: the parts are
    normalised by different positive counts), and the two one-instance
    sums differ."""
    tg = _yolo_targets()
    preds = [T(p) for p in _compute_loss_preds(tg)]
    loss = tl.ComputeLoss(num_keypoints=K, num_classes=NC,
                          kpt_loss_type="oks")

    def cls_sum(mask):
        t = {k: T(v) for k, v in tg.items()}
        t["instance_mask"] = T(mask)
        return loss(preds, t)[1]["cls"].item() * mask.sum()

    alone = []
    for drop in (0, 1):
        mask = tg["instance_mask"].copy()
        mask[0, drop] = False
        alone.append(cls_sum(mask))
    full = cls_sum(tg["instance_mask"])
    assert abs(alone[0] / alone[1] - 1) > 1e-4
    assert min(abs(full / a - 1) for a in alone) < 1e-6


def test_compute_loss_running_sums_match_jax():
    """The running-sum API (set_train_loss, add_loss, mean_loss) over two
    batches of parts, as JAX's; set_train_loss resets it."""
    tg = _yolo_targets()
    preds = _compute_loss_preds(tg)
    jl, pl = JComputeLoss(K, NC), tl.ComputeLoss(K, NC)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    pt = {k: T(v) for k, v in tg.items()}
    for scale in (1.0, 0.5):
        jl.add_loss(jl([jnp.asarray(p * scale) for p in preds], jt)[1])
        pl.add_loss(pl([T(p * scale) for p in preds], pt)[1])
    want, got = jl.mean_loss(), pl.mean_loss()
    assert set(got) == set(want) == {"cls", "kpt", "vis"}
    for k in want:
        _close(got[k], want[k], 1e-5)
    pl.set_train_loss()
    assert pl.mean_loss() == {"cls": 0.0, "kpt": 0.0, "vis": 0.0}


# -- the assigner ----------------------------------------------------------------

def _tal_outputs_equal(got, want):
    labels, boxes, scores, fg, gi = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_array_equal(got[3].numpy(), fg)
    np.testing.assert_array_equal(got[4].numpy(), gi)
    _close(got[1].numpy(), boxes, 1e-6)
    _close(got[2].numpy(), scores, 1e-6)


def test_assigner_matches_jax_on_random_boxes():
    rs = np.random.RandomState(12)
    A = 40
    anc = rs.uniform(0, 32, (A, 2)).astype(np.float32)
    pd = np.concatenate([anc - rs.uniform(1, 8, (A, 2)),
                         anc + rs.uniform(1, 8, (A, 2))], -1)[None] \
        .repeat(2, 0).astype(np.float32)
    sc = rs.uniform(0.01, 0.99, (2, A, 3)).astype(np.float32)
    gb = np.array(jbbox.xywh2xyxy(np.concatenate(
        [rs.uniform(6, 26, (2, 4, 2)), rs.uniform(6, 20, (2, 4, 2))], -1)))
    gl = rs.randint(0, 3, (2, 4)).astype(np.int32)
    mg = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    tal = dict(topk=5, num_classes=3)
    want = JTAL(**tal)(*map(jnp.asarray, (sc, pd, anc, gl, gb, mg)))
    got = tl.TaskAlignedAssigner(**tal)(*map(T, (sc, pd, anc, gl, gb, mg)))
    _tal_outputs_equal(got, want)
    assert np.asarray(want[3]).any()


def test_assigner_ties_take_the_lower_anchor_index():
    """Every score equal and every predicted box the same: the in-box
    anchors of a GT tie on the alignment metric, and top-k (k = 3) takes
    the three lowest anchor indices, as jax.lax.top_k does; the anchors
    outside the box tie at 0 and are not taken."""
    A = 16
    anc = np.stack(np.meshgrid(np.arange(4) + 0.5, np.arange(4) + 0.5,
                               indexing="xy"), -1).reshape(-1, 2) \
        .astype(np.float32)
    pd = np.tile(np.array([0.0, 0.0, 3.0, 4.0], np.float32), (1, A, 1))
    sc = np.full((1, A, 1), 0.01, np.float32)
    gb = np.array([[[1.0, 0.0, 4.0, 4.0]]], np.float32)
    gl = np.zeros((1, 1), np.int32)
    mg = np.ones((1, 1), np.float32)
    want = JTAL(topk=3, num_classes=1)(*map(jnp.asarray,
                                            (sc, pd, anc, gl, gb, mg)))
    got = tl.TaskAlignedAssigner(topk=3, num_classes=1)(
        *map(T, (sc, pd, anc, gl, gb, mg)))
    _tal_outputs_equal(got, want)
    # anchors with x > 1: columns 1-3 of the 4x4 grid, rows first
    assert np.flatnonzero(got[3].numpy()[0]).tolist() == [1, 2, 3]


# -- the v8 losses ---------------------------------------------------------------

REG = 16


@pytest.mark.parametrize("pose", [True, False], ids=["pose", "detection"])
def test_v8_losses_match_jax(pose):
    """v8PoseLoss and v8DetectionLoss at reg_max 16 on 64x64 (grids 8, 4,
    2): total, every part and the gradient w.r.t. each map (through the
    assigner's target scores too, as in JAX), with a zero sample_mask
    row. The box logits favour small distances, so that the predicted
    boxes overlap the GTs and the assigner finds positives (uniform bins
    put every box at 7.5 grid units a side, where IoU^6 is below its
    eps)."""
    tg = _yolo_targets(13)
    rs = np.random.RandomState(14)
    ch = 4 * REG + NC + (3 * K if pose else 0)
    preds = [rs.normal(0, 1, (B, h, w, ch)).astype(np.float32)
             for h, w in GRIDS]
    for p in preds:                   # DFL bins favouring ~0.8 grid units
        p[..., :4 * REG] -= np.tile(0.8 * np.arange(REG), 4)
    if pose:
        jl, tlo = Jv8Pose(K, NC, reg_max=REG), tl.v8PoseLoss(K, NC,
                                                              reg_max=REG)
    else:
        jl, tlo = Jv8Det(NC, reg_max=REG), tl.v8DetectionLoss(NC,
                                                              reg_max=REG)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    (jtotal, jparts), jg = jax.value_and_grad(
        lambda ps: jl(ps, jt), has_aux=True)([jnp.asarray(p) for p in preds])
    tp = [_leaf(p) for p in preds]
    total, parts = tlo(tp, {k: T(v) for k, v in tg.items()})
    total.backward()
    _close(total.item(), float(jtotal), 1e-5)
    assert set(parts) == set(jparts)
    for k in parts:
        assert float(jparts[k]) > 0, k
        _close(parts[k].item(), float(jparts[k]), 1e-5)
    for p, g in zip(tp, jg):
        _close(p.grad.numpy(), g, 1e-5)


def test_dfl_loss_matches_jax():
    rs = np.random.RandomState(15)
    logits = rs.normal(0, 2, (5, 4, REG)).astype(np.float32)
    tgt = rs.uniform(0, REG - 1.01, (5, 4)).astype(np.float32)
    tgt[0] = [0.0, 3.0, 14.99, 7.5]              # bin edges
    want = np.asarray(j_dfl_loss(jnp.asarray(logits), tgt, REG))
    jg = jax.grad(lambda x: jnp.sum(j_dfl_loss(x, tgt, REG)))(
        jnp.asarray(logits))
    tx = _leaf(logits)
    got = tl.dfl_loss(tx, T(tgt), REG)
    got.sum().backward()
    _close(got.detach().numpy(), want, 1e-6)
    _close(tx.grad.numpy(), jg, 1e-5)


# -- the mosaic --------------------------------------------------------------------

def _jax_mosaic_draws(rng, Bm, center_range=(0.35, 0.65)):
    """The draws tpupose.ops.mosaic.mosaic_augment makes from `rng`, in
    the port's layout."""
    r_perm, r_center, r_apply = jax.random.split(rng, 3)
    perms = np.stack([np.asarray(jax.random.permutation(k, Bm))
                      for k in jax.random.split(r_perm, 3)])
    lo, hi = center_range
    centers = np.array(jax.random.uniform(r_center, (Bm, 2), minval=lo,
                                            maxval=hi))
    apply = np.array(jax.random.uniform(r_apply, (Bm,)))
    return {"perms": T(perms.astype(np.int64)), "centers": T(centers),
            "apply": T(apply)}


def _mosaic_batch(Bm=6, Mm=4, Km=3, hw=(48, 40)):
    """Normalized YOLO labels; image i holds min(i + 1, Mm) instances, so
    four sources overflow the Mm slots and `dropped` counts."""
    rs = np.random.RandomState(16)
    images = rs.randint(0, 256, (Bm, *hw, 3)).astype(np.uint8)
    boxes = np.zeros((Bm, Mm, 4), np.float32)
    cls = np.zeros((Bm, Mm), np.int32)
    kpts = np.zeros((Bm, Mm, Km, 3), np.float32)
    mask = np.zeros((Bm, Mm), bool)
    for i in range(Bm):
        for j in range(min(i + 1, Mm)):
            boxes[i, j] = (*rs.uniform(0.2, 0.8, 2), *rs.uniform(0.1, 0.3, 2))
            cls[i, j] = rs.randint(7)
            kpts[i, j] = np.concatenate([rs.uniform(0.1, 0.9, (Km, 2)),
                                         np.full((Km, 1), 2.0)], -1)
            mask[i, j] = True
    return images, boxes, cls, kpts, mask


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_mosaic_matches_jax_given_its_draws(prob):
    """mosaic_augment_normalized on JAX's draws for PRNGKey(3): images,
    boxes, classes, keypoints, mask and `dropped` equal."""
    batch = _mosaic_batch()
    rng = jax.random.PRNGKey(3)
    want = jmosaic.mosaic_augment_normalized(*map(jnp.asarray, batch), rng,
                                             prob=prob)
    draws = _jax_mosaic_draws(rng, len(batch[0]))
    got = tmosaic.mosaic_augment_normalized(*map(T, batch), draws, prob=prob)
    applied = (draws["apply"] < prob).numpy()
    assert applied.any() and (prob == 1.0 or not applied.all())
    for name, g, w in zip(("images", "boxes", "classes", "keypoints",
                           "instance_mask", "dropped"), got, want):
        w = np.asarray(w)
        assert g.dtype == T(np.zeros(1, w.dtype)).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert float(want[5]) > 0


def test_mosaic_draws_are_seeded_and_in_range():
    g = torch.Generator().manual_seed(5)
    d = tmosaic.draw_mosaic(g, 8)
    d2 = tmosaic.draw_mosaic(torch.Generator().manual_seed(5), 8)
    for k in d:
        assert torch.equal(d[k], d2[k])
    assert d["perms"].shape == (3, 8)
    for p in d["perms"]:
        assert sorted(p.tolist()) == list(range(8))
    assert ((d["centers"] >= 0.35) & (d["centers"] <= 0.65)).all()


# -- the synthetic set and OKS-NMS ---------------------------------------------------

def test_synthetic_yolo_dataset_is_bit_equal_to_jax():
    kw = dict(num_samples=5, image_size=(48, 64), num_keypoints=4,
              num_classes=7, max_instances=6, seed=3)
    a, b = SyntheticYoloPoseDataset(**kw), JSynthYolo(**kw)
    assert len(a) == len(b) == 5
    for i in range(5):
        sa, sb = a[i], b[i]
        assert set(sa) == set(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, k
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _nms_case(seed=17, n=24, Kn=5):
    """n poses in 6 clusters of near-duplicates, with keypoint scores."""
    rs = np.random.RandomState(seed)
    base = rs.uniform(0, 200, (6, Kn, 2))
    kp = base[rs.randint(0, 6, n)] + rs.normal(0, 0.5, (n, Kn, 2))
    scores = rs.uniform(0.05, 1.0, n)
    areas = rs.uniform(400, 3000, n)
    ks = rs.uniform(0, 1, (n, Kn))
    return [a.astype(np.float32) for a in (kp, scores, areas, ks)]


@pytest.mark.parametrize("vis", [0.0, 0.2])
def test_oks_nms_matches_jax(vis):
    kp, sc, ar, ks = _nms_case()
    for thr in (0.5, 0.9):
        want = joks.oks_nms(kp, sc, ar, thr, kscores=ks, vis_threshold=vis)
        got = toks.oks_nms(kp, sc, ar, thr, kscores=ks, vis_threshold=vis)
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) < len(sc)
    _close(toks.oks_iou(kp[0], kp[1:], ar[0], ar[1:]),
           joks.oks_iou(kp[0], kp[1:], ar[0], ar[1:]), 1e-6)


def test_soft_oks_nms_matches_jax():
    kp, sc, ar, ks = _nms_case(18)
    wk, ws = joks.soft_oks_nms(kp, sc, ar, max_dets=10, kscores=ks,
                               vis_threshold=0.2)
    gk, gs = toks.soft_oks_nms(kp, sc, ar, max_dets=10, kscores=ks,
                               vis_threshold=0.2)
    np.testing.assert_array_equal(gk, wk)
    _close(gs, ws, 1e-6)
