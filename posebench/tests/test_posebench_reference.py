"""The plain reference against the port's CPU path at a tiny size: the
same weights (made by the benchmark from a seed) through both models,
and the reference's decode, warp and targets against the port's plain
versions."""

import pytest
import torch

from posebench.harness import Cell
from posebench.reference import common as R
from posebench.seeds import make_weights

TINY = {"widths": {"image_size": [64, 64], "heatmap_size": [16, 16]},
        "port": {"train.mixed_precision": False}}
CELLS = {"resnet_pose": "r50-serve-flip-b128",
         "vitpose": "vitpose-s-serve-flip-b128"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(family, seed=3):
    cell = Cell(CELLS[family], TINY)
    ref = cell.reference_module()
    P = make_weights(ref.param_specs(cell.widths), seed, "cpu")
    model = cell.model_module().build(cell.port_config(), P, "cpu")
    return cell, ref, P, model


@pytest.mark.parametrize("family", sorted(CELLS))
def test_eval_forward_matches_port(family):
    cell, ref, P, model = _pair(family)
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model.eval()(x).permute(0, 3, 1, 2)
        want = ref.forward(P, x.permute(0, 3, 1, 2).contiguous(), cell.widths)
    span = (want.amax() - want.amin()).item()
    assert got.shape == want.shape == (3, 17, 16, 16)
    assert (got - want).abs().max().item() < 1e-4 * span


@pytest.mark.parametrize("family", sorted(CELLS))
def test_train_forward_and_gradients_match_port(family):
    """In float64: a random-init ResNet's float32 gradient is itself off
    float64 by a few percent, so float32 could not tell a fault from
    rounding here. The port's plain attention and RoPE tables compute in
    float32 whatever the model's dtype, which bounds the ViT's agreement."""
    tol = {"resnet_pose": (1e-9, 1e-8), "vitpose": (1e-6, 1e-4)}[family]
    cell, ref, P, model = _pair(family)
    model = model.double().train()
    model.compute_dtype = model.param_dtype = torch.float64
    P = {k: v.double() if v.is_floating_point() else v for k, v in P.items()}
    x = torch.randn(4, 64, 64, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    named = list(model.named_parameters())
    got = model(x).permute(0, 3, 1, 2)
    g_got = torch.autograd.grad(got.square().mean(), [p for _, p in named])
    Q = dict(P)
    for n, _ in named:
        Q[n] = P[n].clone().requires_grad_(True)
    want = ref.forward(Q, x.permute(0, 3, 1, 2).contiguous(), cell.widths,
                       train=True)
    g_want = torch.autograd.grad(want.square().mean(), [Q[n] for n, _ in named])
    assert (got - want).abs().max().item() < tol[0] * want.abs().max().item()
    worst = max(((a - b).norm() / b.norm().clamp_min(1e-300)).item()
                for a, b in zip(g_got, g_want))
    assert worst < tol[1]


def test_dark_decode_matches_port_plain_decode():
    from tpupose_torch.ops.decode import decode_heatmaps

    g = torch.Generator().manual_seed(2)
    ys = torch.arange(16.0)[:, None]
    xs = torch.arange(12.0)[None]
    cx = 3 + 6 * torch.rand(2, 5, 1, 1, generator=g)
    cy = 3 + 10 * torch.rand(2, 5, 1, 1, generator=g)
    hm = torch.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0)
    hm = hm + 0.01 * torch.rand(hm.shape, generator=g)
    c1, s1 = decode_heatmaps(hm, "dark", 11, 2.0)
    c2, s2 = R.dark_decode(hm, 11, 2.0)
    assert torch.allclose(c1, c2, atol=1e-4) and torch.equal(s1, s2)
    assert (c2 - torch.cat([cx, cy], -1)[..., 0, :]).abs().max() < 0.3


def test_warp_joints_and_targets_match_port():
    from tpupose_torch.ops.affine import random_affine_augment
    from tpupose_torch.ops.heatmap import gaussian_heatmaps

    g = torch.Generator().manual_seed(4)
    img = torch.randint(0, 256, (3, 32, 24, 3), generator=g,
                        dtype=torch.uint8)
    joints = 2 + 8 * torch.rand(3, 17, 2, generator=g)
    vis = torch.full((3, 17), 2.0)
    mult = torch.tensor([0.8, 1.0, 1.2])
    rot = torch.tensor([-40.0, 0.0, 25.0])
    out, j1, v1 = random_affine_augment(img, joints, vis, mult, rot, (8, 6))
    ref = R.warp_bilinear(img, R.augment_matrices(mult, rot, (32, 24)),
                          (32, 24))
    j2, v2 = R.move_joints(joints, vis, mult, rot, (8, 6))
    assert (out - ref).abs().max() < 1e-3
    assert torch.allclose(j1, j2, atol=1e-5) and torch.equal(v1, v2)
    t1, w1 = gaussian_heatmaps(j1, v1, (8, 6), 2.0)
    t2, w2 = R.gaussian_targets(j2, v2, (8, 6), 2.0)
    assert torch.allclose(t1, t2, atol=1e-6) and torch.equal(w1, w2)
