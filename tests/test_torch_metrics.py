"""The port's metric library (tpupose_torch/metrics) against the JAX
package's (tpupose/metrics): the same seeded numpy inputs through both
twins, every returned value equal within 1e-6 (absolute, or relative for
values above 1: MPJPE and EPE sum float32 distances, whose summation
order differs between XLA and numpy).

The cases are the fixtures of tests/test_metrics_library.py and
tests/test_coco_evaluator.py (perfect and hopeless predictions, area
ranges and recall, an empty range reporting -1, a zero-visible GT as an
ignore region with and without its box, the max_dets cap, an ignored GT
matched once, the empty schema) plus seeded random batches over several
images and classes.
"""

import numpy as np
import pytest

import tpupose.metrics as J
import tpupose.metrics.oks_ap as J_oks
import tpupose.metrics.pck as J_pck
import tpupose_torch.metrics as P
import tpupose_torch.metrics.oks_ap as P_oks
import tpupose_torch.metrics.pck as P_pck

TOL = 1e-6


def _hand_pck(M, _):
    gt = np.array([[[0.0, 0.0], [10.0, 0.0], [10.0, 10.0]]])
    pred = gt + np.array([[[3.0, 0.0], [0.0, 6.0], [0.0, 0.0]]])
    m = M.PCK(alpha=0.5)
    m.update(pred, gt, np.ones((1, 3)))
    return m.compute()


def _random_pose(rng, B=6, K=17, noise=6.0):
    gt = rng.uniform(10, 120, (B, K, 2)).astype(np.float32)
    pred = gt + rng.normal(0, noise, (B, K, 2)).astype(np.float32)
    vis = (rng.uniform(size=(B, K)) > 0.2).astype(np.float32)
    vis[0] = 0                                    # an instance with none
    return pred, gt, vis


def _random_pck(M, _):
    rng = np.random.RandomState(0)
    m = M.PCK(alpha=0.2)
    for _ in range(3):
        m.update(*_random_pose(rng))
    return m.compute()


def _pck_normalizer(M, _):
    rng = np.random.RandomState(1)
    pred, gt, vis = _random_pose(rng)
    m = M.PCK(alpha=0.1)
    m.update(pred, gt, vis, normalizer=rng.uniform(20, 80, len(gt)))
    return m.compute()


def _pck_batch(M, mods):
    rng = np.random.RandomState(2)
    pred, gt, vis = _random_pose(rng)
    c, n = mods["pck"].pck_batch(pred, gt, vis, alpha=0.15)
    side = mods["pck"]._bbox_max_side(gt, vis)
    return {"correct": int(c), "total": int(n), "side": np.asarray(side)}


def _hand_pckh(M, _):
    gt = np.zeros((1, 3, 2))
    gt[0, 1] = [10, 0]
    gt[0, 2] = [5, 5]
    pred = gt.copy()
    pred[0, 2] += [2.9, 0]
    pred[0, 0] += [4.0, 0]
    m = M.PCKh(alpha=0.5, head_indices=(0, 1))
    m.update(pred, gt, np.ones((1, 3)))
    return m.compute()


def _random_pckh(M, _):
    rng = np.random.RandomState(3)
    m = M.PCKh()
    for _ in range(2):
        m.update(*_random_pose(rng, K=16))
    return m.compute()


def _mpjpe_mask(M, _):
    gt = np.zeros((1, 2, 2))
    pred = gt + np.array([[[3, 4], [30, 40]]])
    m = M.MPJPE()
    m.update(pred, gt, np.array([[1, 0]]))
    return m.compute()


def _random_mpjpe(M, _):
    rng = np.random.RandomState(4)
    m = M.MPJPE()
    for _ in range(3):
        m.update(*_random_pose(rng, B=16))
    pred, gt, _ = _random_pose(rng)
    m.update(pred, gt)                            # no visibility mask
    return m.compute()


def _auc(M, _):
    gt = np.array([[[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]]], np.float32)
    vis = np.ones((1, 3), np.float32)
    m = M.AUC(max_threshold=0.5, num_steps=20)
    m.update(gt, gt, vis)
    perfect = m.compute()
    m.reset()
    m.update(gt + np.array([1.1, 0.0], np.float32), gt, vis)
    return {**{"perfect_" + k: v for k, v in perfect.items()}, **m.compute()}


def _random_auc_epe(M, _):
    rng = np.random.RandomState(5)
    a, e = M.AUC(), M.EPE()
    for _ in range(3):
        batch = _random_pose(rng)
        a.update(*batch)
        e.update(*batch)
    pred, gt, vis = _random_pose(rng)
    a.update(pred, gt, vis, normalizer=rng.uniform(30, 60, len(gt)))
    return {**a.compute(), **e.compute(), "empty": M.AUC().compute()["auc"]}


def _oks_matrix(M, mods):
    rng = np.random.RandomState(6)
    pred, gt, vis = _random_pose(rng, B=5)
    area = rng.uniform(500, 9000, len(gt)).astype(np.float32)
    out = {"oks": np.asarray(mods["oks"].compute_oks(pred[:3], gt, vis,
                                                     area))}
    for k in (5, 17, 20):
        out[f"sigmas{k}"] = mods["oks"].default_sigmas(k)
    out["fallback"] = mods["oks"]._bbox_fallback_oks(
        pred, (30.0, 40.0, 50.0, 60.0), 3000.0, M.OKS_SIGMAS)
    return out


def _oksap_perfect(M, _):
    rng = np.random.RandomState(0)
    m = M.OKSAP(num_classes=1)
    for _ in range(4):
        gt = rng.uniform(10, 90, (3, 17, 2)).astype(np.float32)
        m.update(gt, rng.uniform(0.5, 1.0, 3).astype(np.float32), gt,
                 np.ones((3, 17), np.float32), np.full(3, 2500.0, np.float32))
    return m.compute()


def _oksap_wrong(M, _):
    rng = np.random.RandomState(0)
    m = M.OKSAP(num_classes=1)
    gt = rng.uniform(10, 90, (3, 17, 2)).astype(np.float32)
    m.update(gt + 300.0, np.ones(3, np.float32), gt, np.ones((3, 17)),
             np.full(3, 2500.0))
    return m.compute()


def _oksap_area_ranges(M, _):
    rng = np.random.RandomState(1)
    m = M.OKSAP(num_classes=1)
    out = {}
    for rep in range(2):
        m.reset()
        for _ in range(3):
            gt = rng.uniform(30, 200, (2, 17, 2)).astype(np.float32)
            area = np.array([50.0 ** 2, 150.0 ** 2], np.float32)
            pred = gt.copy()
            if rep == 0:
                pred[0] += 500.0
            m.update(pred, np.array([0.9, 0.8], np.float32), gt,
                     np.ones((2, 17), np.float32), area, pred_area=area)
        out.update({f"{rep}_{k}": v for k, v in m.compute().items()})
    return out


def _oksap_empty_range(M, _):
    rng = np.random.RandomState(2)
    m = M.OKSAP(num_classes=1)
    for _ in range(2):
        gt = rng.uniform(30, 200, (2, 17, 2)).astype(np.float32)
        area = np.full(2, 150.0 ** 2, np.float32)
        m.update(gt, np.array([0.9, 0.8], np.float32), gt,
                 np.ones((2, 17), np.float32), area, pred_area=area)
    return m.compute()


def _one_gt(K=17, at=(50.0, 50.0), spread=30.0):
    gk = np.zeros((1, K, 2), np.float32)
    gk[0, :, 0] = at[0] + np.linspace(0, spread, K)
    gk[0, :, 1] = at[1] + np.linspace(0, spread, K)
    return gk, np.ones((1, K), np.float32), np.asarray([1600.0], np.float32)


def _oksap_ignore_region(M, _):
    K = 17
    gk, gv, ga = _one_gt(K)
    gk2 = np.concatenate([gk, np.zeros((1, K, 2), np.float32)])
    gv2 = np.concatenate([gv, np.zeros((1, K), np.float32)])
    ga2 = np.concatenate([ga, [3600.0]]).astype(np.float32)
    gb2 = np.asarray([[40, 40, 50, 50], [200, 200, 60, 60]], np.float32)
    pk = np.concatenate([gk, np.full((1, K, 2), 220.0, np.float32)])
    ps = np.asarray([0.9, 0.95], np.float32)
    a, b = M.OKSAP(num_classes=1), M.OKSAP(num_classes=1)
    a.update(pk, ps, gk2, gv2, ga2, gt_bbox=gb2)
    b.update(gk.copy(), np.asarray([0.9], np.float32), gk2, gv2, ga2)
    return {**{"box_" + k: v for k, v in a.compute().items()},
            **b.compute()}


def _oksap_max_dets(M, _):
    K = 17
    gk, gv, ga = _one_gt(K)
    pk = np.concatenate([np.full((20, K, 2), 500.0, np.float32), gk])
    ps = np.concatenate([np.linspace(0.9, 0.5, 20), [0.1]]).astype(np.float32)
    out = {}
    for cap in (20, 100):
        m = M.OKSAP(num_classes=1, max_dets=cap)
        m.update(pk, ps, gk, gv, ga)
        out.update({f"{cap}_{k}": v for k, v in m.compute().items()})
    return out


def _oksap_ignored_matched_once(M, _):
    K = 17
    gk, gv, ga = _one_gt(K)
    big = np.zeros((1, K, 2), np.float32)
    big[0, :, 0] = 300 + np.linspace(0, 150, K)
    big[0, :, 1] = 300 + np.linspace(0, 150, K)
    pk = np.concatenate([gk, big, big + 0.5])
    m = M.OKSAP(num_classes=1)
    m.update(pk, np.asarray([0.5, 0.95, 0.9], np.float32),
             np.concatenate([gk, big]), np.concatenate([gv, gv]),
             np.concatenate([ga, [22500.0]]).astype(np.float32),
             pred_area=np.full(3, 1600.0, np.float32))
    return m.compute()


def _oksap_empty_schema(M, _):
    return M.OKSAP(num_classes=2).compute()


def _oksap_random(M, _):
    """Six images of 1-4 GTs and 0-5 detections in two classes, with
    padding masks, partly visible joints, ties in score, a default and an
    explicit pred_area, explicit sigmas and thresholds."""
    rng = np.random.RandomState(7)
    out = {}
    for sig, thr in ((None, None), (np.full(17, 0.05, np.float32),
                                    np.arange(0.3, 0.95, 0.1))):
        m = M.OKSAP(num_classes=2, sigmas=sig, thresholds=thr)
        for img in range(6):
            M_, N = rng.randint(1, 5), rng.randint(0, 6)
            gt = rng.uniform(0, 300, (M_, 17, 2)).astype(np.float32)
            vis = (rng.uniform(size=(M_, 17)) > 0.3).astype(np.float32)
            area = rng.uniform(400, 20000, M_).astype(np.float32)
            src = rng.randint(0, M_, N)
            pred = gt[src] + rng.normal(0, 4, (N, 17, 2)).astype(np.float32)
            pred[:, :2] = -1.0                  # decode sentinels
            scores = np.round(rng.uniform(0, 1, N), 1).astype(np.float32)
            kw = dict(pred_cls=rng.randint(0, 2, N),
                      gt_cls=rng.randint(0, 2, M_),
                      pred_valid=rng.uniform(size=N) > 0.1,
                      gt_valid=rng.uniform(size=M_) > 0.1)
            if img % 2:
                kw["pred_area"] = area[src]
            m.update(pred, scores, gt, vis, area, **kw)
        key = "explicit" if sig is not None else "default"
        out.update({f"{key}_{k}": v for k, v in m.compute().items()})
    return out


CASES = {f.__name__[1:]: f for f in (
    _hand_pck, _random_pck, _pck_normalizer, _pck_batch, _hand_pckh,
    _random_pckh, _mpjpe_mask, _random_mpjpe, _auc, _random_auc_epe,
    _oks_matrix, _oksap_perfect, _oksap_wrong, _oksap_area_ranges,
    _oksap_empty_range, _oksap_ignore_region, _oksap_max_dets,
    _oksap_ignored_matched_once, _oksap_empty_schema, _oksap_random)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    fn = CASES[case]
    want = fn(J, {"pck": J_pck, "oks": J_oks})
    got = fn(P, {"pck": P_pck, "oks": P_oks})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)


def test_port_metrics_compute_in_float32():
    """The OKS matrix, PCK's normalizer and the bbox fallback's inputs are
    float32 (the JAX package's jnp default): float64 would move threshold
    decisions against the reference."""
    rng = np.random.RandomState(8)
    pred, gt, vis = _random_pose(rng)
    pred, gt = pred.astype(np.float64), gt.astype(np.float64)
    assert P_oks.compute_oks(pred, gt, vis, np.full(len(gt), 900.0)) \
        .dtype == np.float32
    assert P_pck._bbox_max_side(gt, vis).dtype == np.float32


def test_registry_names_what_the_trainer_builds():
    assert set(P.METRICS) == {"oks_ap", "pck", "pckh", "mpjpe", "auc",
                              "epe"}
    np.testing.assert_array_equal(P.OKS_SIGMAS, J.OKS_SIGMAS)
