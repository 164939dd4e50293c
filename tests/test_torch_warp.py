"""The warp kernel's plain versions (tpupose_torch/ops/affine.
batched_affine_warp and ops/cuda_warp.affine_warp / crops_from_frames on
CPU tensors) against the JAX oracle (tpupose.ops.affine.
batched_affine_warp) and the Pallas kernel in interpret mode
(tpupose.ops.pallas_warp), on seeded numpy inputs.

Tolerance: atol 1e-2 on 0-255 pixel values. The oracle and the port do
the same float32 operations in the same order; the Pallas kernel's
hat-weight matmuls sum the same taps in another order (its own tests
hold it to the oracle at 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.ops.affine import batched_affine_warp as j_warp
from tpupose.ops.pallas_warp import (pallas_affine_warp,
                                     pallas_crops_from_frames)
from tpupose_torch.ops import _build, cuda_warp
from tpupose_torch.ops.affine import affine_warp, batched_affine_warp

ATOL = 1e-2


def _mats(n, h, w, seed, max_rot=1.0, lo=0.6, hi=1.4):
    rs = np.random.RandomState(seed)
    th = rs.uniform(-max_rot, max_rot, n)
    mu = rs.uniform(lo, hi, n)
    A = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2) * mu[:, None,
                                                                  None]
    c = np.array([w / 2, h / 2])
    t = c - A @ c
    return np.concatenate([A, t[..., None]], -1).astype(np.float32)


def _images(n, h, w, seed, dtype):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    if dtype == "float32":
        x = x.astype(np.float32) + rs.uniform(0, 1, x.shape).astype(
            np.float32)
    return x


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("out_size", [(32, 24), (16, 24)],
                         ids=["same_size", "rect_downscale"])
def test_batched_warp_vs_oracle_and_pallas(dtype, out_size):
    imgs = _images(3, 32, 24, seed=1, dtype=dtype)
    mats = _mats(3, 32, 24, seed=2)
    got = batched_affine_warp(torch.from_numpy(imgs), torch.from_numpy(mats),
                              out_size).numpy()
    assert got.dtype == np.float32 and got.shape == (3, *out_size, 3)
    want = np.asarray(j_warp(jnp.asarray(imgs, jnp.float32),
                             jnp.asarray(mats), out_size))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pal = np.asarray(pallas_affine_warp(jnp.asarray(imgs), jnp.asarray(mats),
                                        out_size, interpret=True))
    np.testing.assert_allclose(got, pal, atol=ATOL, rtol=0)


def test_single_image_warp_is_the_batched_one():
    imgs = _images(2, 20, 16, seed=3, dtype="uint8")
    mats = _mats(2, 20, 16, seed=4)
    one = affine_warp(torch.from_numpy(imgs[1]), torch.from_numpy(mats[1]),
                      (12, 10))
    both = batched_affine_warp(torch.from_numpy(imgs),
                               torch.from_numpy(mats), (12, 10))
    assert torch.equal(one, both[1])


def test_view_fully_outside_is_zero():
    imgs = np.full((1, 16, 16, 3), 200, np.uint8)
    mats = np.array([[[1.0, 0.0, 100.0], [0.0, 1.0, 100.0]]], np.float32)
    got = cuda_warp.affine_warp(torch.from_numpy(imgs),
                                torch.from_numpy(mats), (16, 16))
    assert got.abs().max().item() == 0.0
    pal = np.asarray(pallas_affine_warp(jnp.asarray(imgs), jnp.asarray(mats),
                                        (16, 16), interpret=True))
    assert pal.max() == 0.0


def test_crops_from_frames_vs_pallas():
    """D=3 crops per frame: crop n reads frame n // 3."""
    frames = _images(2, 40, 32, seed=5, dtype="uint8")
    mats = _mats(6, 40, 32, seed=6)
    got = cuda_warp.crops_from_frames(torch.from_numpy(frames),
                                      torch.from_numpy(mats), (16, 24))
    want = np.asarray(pallas_crops_from_frames(
        jnp.asarray(frames), jnp.asarray(mats), (16, 24), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="multiple"):
        cuda_warp.crops_from_frames(torch.from_numpy(frames),
                                    torch.from_numpy(mats[:5]), (16, 24))


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """A CPU tensor takes the plain version: no kernel is built or bound
    and no launch is counted."""
    def fail(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")

    for name in ("build_all", "library", "bind"):
        monkeypatch.setattr(_build, name, fail)
    n0, c0 = cuda_warp.affine_warp.launches, cuda_warp.crops_from_frames \
        .launches
    imgs = torch.from_numpy(_images(2, 16, 12, seed=7, dtype="uint8"))
    mats = torch.from_numpy(_mats(2, 16, 12, seed=8))
    cuda_warp.affine_warp(imgs, mats, (8, 6))
    cuda_warp.crops_from_frames(imgs[:1], mats, (8, 6))
    assert cuda_warp.affine_warp.launches == n0
    assert cuda_warp.crops_from_frames.launches == c0
