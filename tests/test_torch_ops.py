"""tpupose_torch ops vs the JAX package on the CPU: normalize, heatmap
decode (dark / argmax / quarter_offset, and the fused decode's plain
version), flip merging and the affine geometry. Inputs come from numpy
seeds and go to both sides as float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.ops import affine as jaffine
from tpupose.ops import decode as jdecode
from tpupose.ops.heatmap import gaussian_heatmaps
from tpupose.ops.preprocess import normalize_images as j_normalize
from tpupose_torch.ops import affine as taffine
from tpupose_torch.ops import decode as tdecode
from tpupose_torch.ops.cuda_decode import dark_decode
from tpupose_torch.ops.preprocess import normalize_images as t_normalize


def _close(got, want, rtol=1e-4, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol + rtol * np.abs(want).max())


@pytest.mark.parametrize("scale_only", [False, True])
def test_normalize_images(scale_only):
    imgs = np.random.RandomState(0).randint(0, 256, (2, 8, 6, 3)) \
        .astype(np.uint8)
    want = j_normalize(jnp.asarray(imgs), dtype=jnp.float32,
                       scale_only=scale_only)
    got = t_normalize(torch.from_numpy(imgs), dtype=torch.float32,
                      scale_only=scale_only)
    _close(got.numpy(), want, rtol=1e-6)
    # the default working dtype rounds to bf16 on both sides identically
    wb = np.asarray(j_normalize(jnp.asarray(imgs)).astype(jnp.float32))
    gb = t_normalize(torch.from_numpy(imgs)).float().numpy()
    np.testing.assert_array_equal(gb, wb)


def _gauss_maps(B=2, K=5, size=(64, 48), seed=0):
    rng = np.random.RandomState(seed)
    joints = rng.uniform([2, 2], [size[1] - 3, size[0] - 3],
                         (B, K, 2)).astype(np.float32)
    hm, _ = gaussian_heatmaps(jnp.asarray(joints),
                              jnp.ones((B, K), jnp.float32), size)
    return np.array(hm, np.float32), joints


def _edge_case_maps():
    """zero map, border peaks, exact ties, a negative map, a near-flat one."""
    hm = np.zeros((1, 7, 32, 24), np.float32)
    hm[0, 1, 0, 5] = 1.0                       # top border peak
    hm[0, 2, 10, 23] = 0.7                     # right border peak
    hm[0, 3, 12, 6] = 0.9                      # tie: first in row-major wins
    hm[0, 3, 12, 15] = 0.9
    hm[0, 3, 20, 2] = 0.9
    hm[0, 4] = -np.abs(np.random.RandomState(1).randn(32, 24))
    rs = np.random.RandomState(2)
    hm[0, 5] = 0.5 + 1e-3 * rs.rand(32, 24)
    hm[0, 6, 16, 12] = 0.3                     # isolated interior peak
    hm[0, 6, 15:18, 11:14] += 0.1
    return hm


@pytest.mark.parametrize("method", ["dark", "argmax", "quarter_offset"])
@pytest.mark.parametrize("maps", ["gauss", "edge"])
def test_decode_heatmaps(method, maps):
    hm = _gauss_maps()[0] if maps == "gauss" else _edge_case_maps()
    wc, ws = jdecode.decode_heatmaps(jnp.asarray(hm), method, 11, 2.0)
    gc, gs = tdecode.decode_heatmaps(torch.from_numpy(hm), method, 11, 2.0)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4)


def test_edge_cases_semantics():
    c, s = tdecode.get_max_preds(torch.from_numpy(_edge_case_maps()))
    c = c.numpy()
    assert tuple(c[0, 0]) == (-1.0, -1.0) and s[0, 0] == 0.0
    assert tuple(c[0, 3]) == (6.0, 12.0)
    assert tuple(c[0, 4]) == (-1.0, -1.0)


@pytest.mark.parametrize("maps", ["gauss", "edge"])
def test_dark_decode_plain_version_matches_jax(maps):
    """The fused decode's plain version (the CPU branch of its wrapper)
    vs the JAX decode_heatmaps(method="dark")."""
    hm, joints = _gauss_maps() if maps == "gauss" \
        else (_edge_case_maps(), None)
    wc, ws = jdecode.decode_heatmaps(jnp.asarray(hm), "dark", 11, 2.0)
    gc, gs = dark_decode(torch.from_numpy(hm), 11, 2.0)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4)
    if joints is not None:
        assert np.abs(gc.numpy() - joints).max() < 0.1


@pytest.mark.parametrize("shift", [True, False])
def test_merge_flip(shift):
    rs = np.random.RandomState(3)
    a = rs.rand(2, 17, 16, 12).astype(np.float32)
    b = rs.rand(2, 17, 16, 12).astype(np.float32)
    from tpupose_torch.engine.evaluator import COCO_FLIP_PAIRS

    want = jdecode.merge_flip(jnp.asarray(a), jnp.asarray(b),
                              COCO_FLIP_PAIRS, shift=shift)
    got = tdecode.merge_flip(torch.from_numpy(a), torch.from_numpy(b),
                             COCO_FLIP_PAIRS, shift=shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("udp", [False, True])
@pytest.mark.parametrize("rot", [0.0, 30.0])
def test_get_affine_matrix(udp, rot):
    center = np.array([100.5, 80.25], np.float32)
    scale = np.array([150.0, 200.0], np.float32)
    want = jaffine.get_affine_matrix(jnp.asarray(center), jnp.asarray(scale),
                                     rot, (64, 48), udp=udp)
    got = taffine.get_affine_matrix(torch.from_numpy(center),
                                    torch.from_numpy(scale), rot, (64, 48),
                                    udp=udp)
    _close(got.numpy(), want, rtol=1e-5)
    _close(taffine.get_affine_matrix_np(center, scale, rot, (64, 48), udp),
           want, rtol=1e-5)
    _close(taffine.invert_affine(got).numpy(),
           jaffine.invert_affine(want), rtol=1e-4)


@pytest.mark.parametrize("udp", [False, True])
def test_transform_preds_batched(udp):
    rs = np.random.RandomState(4)
    coords = rs.uniform(0, 48, (3, 17, 2)).astype(np.float32)
    centers = rs.uniform(50, 150, (3, 2)).astype(np.float32)
    scales = rs.uniform(100, 200, (3, 2)).astype(np.float32)
    want = np.stack([np.asarray(jaffine.transform_preds(
        jnp.asarray(coords[i]), jnp.asarray(centers[i]),
        jnp.asarray(scales[i]), (64, 48), udp=udp)) for i in range(3)])
    got = taffine.transform_preds(torch.from_numpy(coords),
                                  torch.from_numpy(centers),
                                  torch.from_numpy(scales), (64, 48), udp=udp)
    _close(got.numpy(), want, rtol=1e-5)
