"""The hand-written Hopper kernels against their plain versions, on the
card. Needs an NVIDIA GPU and nvcc: each test skips where
torch.cuda.is_available() is false (decided inside the fixture, never at
import). Run on a GPU machine with `python -m pytest -m cuda
tests/test_torch_cuda.py -q`.

Tolerances: the bf16 kernels and their plain versions round the same
intermediates to bf16; they differ by float32 summation order, which
flips an occasional bf16 rounding of an intermediate (one bf16 ulp,
2^-8 relative), so values agree to a few bf16 ulps of the tensor's range.
The int8 kernels' products are exact and their epilogues repeat the plain
versions' float32 operations in order, so they must be bit-equal. So must
the warp kernel (K7), which computes its coordinates and blend with the
plain version's float32 operations in order and no FMA contraction.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    g = torch.Generator().manual_seed(0)
    return SimpleBaseline("resnet50", 17, dtype=torch.bfloat16,
                          device="cuda", generator=g)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def test_stem_kernel(card):
    from tpupose_torch.ops.cuda_stem import (fold_stem_weights, stem_pool,
                                             stem_pool_reference)

    g = torch.Generator().manual_seed(1)
    x = (torch.rand((2, 256, 192, 3), generator=g) * 4 - 2).cuda() \
        .to(torch.bfloat16)
    w = fold_stem_weights(card.backbone)
    assert _rel(stem_pool(x, w), stem_pool_reference(x, w)) < 2e-2


@pytest.mark.parametrize("inp", ["normalized", "centered_raw"])
@pytest.mark.parametrize("B,H,W", [(1, 256, 192), (3, 256, 192),
                                   (128, 256, 192), (2, 256, 256),
                                   (2, 384, 288), (1, 128, 640),
                                   (3, 37, 53)],
                         ids=["b1", "b3", "b128", "mpii_256x256", "384x288",
                              "three_chunks_128x640", "odd_37x53"])
def test_stem_kernel_every_shape(card, inp, B, H, W):
    """K1 at the R50 serving shapes (one wgmma N of 104, one chunk), at
    simple_baseline_mpii.yaml's 256x256 and at 384x288 (N = 152, one
    chunk), at 128x640 (N = 152, three chunks of 75 pooled columns with
    their one column of overlap and the bulk store at each chunk's first
    pooled column) and at an odd size (ragged strip, columns past the conv
    map masked), on the bf16 route's normalized input and on the int8
    route's centered raw pixels (values up to +-150) with the normalize's
    scale folded into the weights."""
    from tpupose_torch.ops.cuda_stem import (center_raw, fold_stem_weights,
                                             stem_pool, stem_pool_reference)
    from tpupose_torch.ops.preprocess import IMAGENET_STD, normalize_images

    g = torch.Generator().manual_seed(20 + B + H)
    raw = torch.randint(0, 256, (B, H, W, 3), generator=g,
                        dtype=torch.uint8).cuda()
    if inp == "normalized":
        x = normalize_images(raw).to(torch.bfloat16)
        w = fold_stem_weights(card.backbone)
    else:
        x = center_raw(raw).to(torch.bfloat16)
        w = fold_stem_weights(card.backbone, torch.bfloat16, input_scale=[
            1.0 / (255.0 * sd) for sd in IMAGENET_STD])
    n0 = stem_pool.launches
    got = stem_pool(x, w)
    assert stem_pool.launches == n0 + 1
    want = stem_pool_reference(x, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert _rel(got, want) < 2e-2


def test_stem_rejects_what_it_does_not_take(card):
    """K1 takes bf16 (B, H, W, 3) and weights from fold_stem_weights in
    bf16 on x's device; anything else raises before a launch."""
    from tpupose_torch.ops.cuda_stem import fold_stem_weights, stem_pool

    w = fold_stem_weights(card.backbone)
    x = torch.zeros((2, 64, 48, 3), dtype=torch.bfloat16, device="cuda")
    n0 = stem_pool.launches
    with pytest.raises(ValueError, match="bfloat16"):
        stem_pool(x.float(), w)
    with pytest.raises(ValueError, match="bfloat16"):
        stem_pool(torch.zeros((2, 64, 48, 4), dtype=torch.bfloat16,
                              device="cuda"), w)
    with pytest.raises(ValueError, match="fold_stem_weights"):
        stem_pool(x, {"w": w["w"].float(), "bias": w["bias"]})
    with pytest.raises(ValueError, match="fold_stem_weights"):
        stem_pool(x, {k: v.cpu() for k, v in w.items()})
    assert stem_pool.launches == n0
    # a view that starts off a 16-byte boundary is copied, not refused
    flat = torch.zeros(2 * 64 * 48 * 3 + 1, dtype=torch.bfloat16,
                       device="cuda")
    xv = flat[1:].view(2, 64, 48, 3)
    assert xv.data_ptr() % 16
    assert stem_pool(xv, w).shape == (2, 16, 12, 64)


def test_layer1_and_bridge_kernels(card):
    from tpupose_torch.ops.cuda_bridge import (bridge, bridge_reference,
                                               fold_bridge_weights)
    from tpupose_torch.ops.cuda_layer1 import (fold_layer1_weights, layer1,
                                               layer1_reference)

    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 64, 48, 64), generator=g).cuda().to(torch.bfloat16)
    w = fold_layer1_weights(card.backbone)
    assert _rel(layer1(x, w), layer1_reference(x, w)) < 2e-2
    y = torch.rand((2, 64, 48, 256), generator=g).cuda().to(torch.bfloat16)
    wb = fold_bridge_weights(card.backbone)
    assert _rel(bridge(y, wb), bridge_reference(y, wb)) < 2e-2


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("variant", [0, 1], ids=["downsample", "identity"])
def test_layer1_kernel_every_variant(card, variant, B):
    """K2 (csrc/bottleneck.cu: wgmma products fed by TMA, clusters of two
    blocks) one launch per variant against bottleneck_reference at the
    R50 shape 64x48: variant 0 is layer1 block 0 (64 -> 256, downsample),
    variant 1 blocks 1-2 (256 -> 256, identity). B=1 is 12 clusters of
    one image, B=128 the serving batch. Then the three launches against
    layer1_reference."""
    from tpupose_torch.ops.cuda_layer1 import (bottleneck_reference,
                                               fold_layer1_weights,
                                               launch_bottleneck, layer1,
                                               layer1_reference)

    w = fold_layer1_weights(card.backbone)
    cin = 64 if variant == 0 else 256
    g = torch.Generator().manual_seed(20 + 2 * B + variant)
    x = torch.rand((B, 64, 48, cin), generator=g).cuda().to(torch.bfloat16)
    blk = w[0] if variant == 0 else w[1]
    got = launch_bottleneck(x, blk, variant)
    torch.cuda.synchronize()
    assert got.shape == (B, 64, 48, 256) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert _rel(got, bottleneck_reference(x, blk, 1)) < 2e-2
    if variant == 0:
        n0 = layer1.launches
        got = layer1(x, w)
        assert layer1.launches == n0 + 3
        torch.cuda.synchronize()
        assert _rel(got, layer1_reference(x, w)) < 2e-2


def test_layer1_rejects_what_it_does_not_take(card):
    from tpupose_torch.ops.cuda_layer1 import fold_layer1_weights, layer1

    w = fold_layer1_weights(card.backbone)
    x = torch.zeros((1, 48, 40, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even count"):
        layer1(x, w)                        # 3 x 5 tiles of 16 x 8
    with pytest.raises(ValueError, match="16x8"):
        layer1(x.new_zeros((1, 56, 48, 64)), w)
    with pytest.raises(ValueError, match="bfloat16"):
        layer1(torch.zeros((1, 64, 48, 64), device="cuda"), w)
    with pytest.raises(ValueError, match="weight w2"):
        layer1(x.new_zeros((1, 64, 48, 64)),
               [dict(w[0], w2=w[0]["w2"].float())] + w[1:])


@pytest.mark.parametrize("B", [1, 3, 128])
def test_bridge_kernel(card, B):
    """K3 (csrc/bridge.cu: wgmma products fed by TMA, clusters of two
    blocks) against bridge_reference at 64x48x256 inputs: B=1 is one
    cluster per pair of tiles of one image, B=128 the serving batch."""
    from tpupose_torch.ops.cuda_bridge import (bridge, bridge_reference,
                                               fold_bridge_weights)

    g = torch.Generator().manual_seed(10 + B)
    x = torch.rand((B, 64, 48, 256), generator=g).cuda().to(torch.bfloat16)
    w = fold_bridge_weights(card.backbone)
    n0 = bridge.launches
    got = bridge(x, w)
    assert bridge.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.shape == (B, 32, 24, 512) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert _rel(got, bridge_reference(x, w)) < 2e-2


def test_bridge_rejects_what_it_does_not_take(card):
    from tpupose_torch.ops.cuda_bridge import bridge, fold_bridge_weights

    w = fold_bridge_weights(card.backbone)
    x = torch.zeros((1, 48, 48, 256), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even count"):
        bridge(x, w)                        # 3 x 3 tiles of 8 x 8
    with pytest.raises(ValueError, match="bfloat16"):
        bridge(torch.zeros((1, 64, 48, 256), device="cuda"), w)
    plain = {k: v for k, v in w.items() if k != "tmaps"}
    with pytest.raises(ValueError, match="tensor maps"):
        bridge(x.new_zeros((1, 64, 48, 256)), plain)


def test_dark_decode_kernel(card):
    from tpupose_torch.ops.cuda_decode import (dark_decode,
                                               dark_decode_reference)

    rs = np.random.RandomState(3)
    ys, xs = np.mgrid[0:64, 0:48]
    mu = rs.uniform(3, 44, (4, 17, 2))
    hm = np.exp(-((xs - mu[..., 0, None, None]) ** 2
                  + (ys - mu[..., 1, None, None]) ** 2) / 8.0)
    hm[0, 0] = 0.0
    hm = torch.from_numpy(hm.astype(np.float32)).cuda()
    c, s = dark_decode(hm)
    rc, rsc = dark_decode_reference(hm)
    assert torch.equal(s, rsc)
    assert (c - rc).abs().max().item() < 1e-3


@pytest.fixture(scope="module")
def int8_engine(card):
    """The int8 engine of the card model, calibrated on two seeded crops."""
    from tpupose_torch.ops.cuda_engine import CudaServingEngine

    imgs = np.random.RandomState(4).randint(0, 256, (2, 256, 192, 3)) \
        .astype(np.uint8)
    return CudaServingEngine.build(card, imgs)


@pytest.mark.parametrize("block", [0, 1, 3], ids=["projection", "identity",
                                                  "stride2"])
def test_int8_bottleneck_kernel(int8_engine, block):
    """K5: the kernel's int products are exact and its epilogue repeats
    the plain version's float32 operations in order: bit-equal."""
    from tpupose_torch.ops.cuda_stages import chunk_reference, run_chunk

    blk = int8_engine.blocks[block]
    hw = (64, 48)                    # layer1 and block2_0 inputs
    g = torch.Generator().manual_seed(5 + block)
    x = torch.randint(0, 60, (2, *hw, blk.cin), generator=g,
                      dtype=torch.int8).cuda()
    got = run_chunk(x, blk)
    torch.cuda.synchronize()
    assert torch.equal(got, chunk_reference(x, blk))


# (block index, input H x W) of every distinct R50 block shape: the
# projection and identity blocks of each stage, stride 2 from layer2 on
_R50_BLOCKS = [(0, (64, 48)), (1, (64, 48)), (3, (64, 48)), (4, (32, 24)),
               (7, (32, 24)), (8, (16, 12)), (13, (16, 12)), (14, (8, 6))]


_R50_IDS = ["l1_proj", "l1_id", "l2_proj_s2", "l2_id", "l3_proj_s2", "l3_id",
            "l4_proj_s2", "l4_id"]


@pytest.mark.parametrize(
    "block,hw,B",
    [(b, hw, 3) for b, hw in _R50_BLOCKS]
    + [(b, hw, 128) for b, hw in _R50_BLOCKS if b in (0, 3, 13, 14)],
    ids=[f"{n}_B3" for n in _R50_IDS]
    + [f"{n}_B128" for n, (b, _) in zip(_R50_IDS, _R50_BLOCKS)
       if b in (0, 3, 13, 14)])
def test_int8_bottleneck_kernel_every_r50_block(int8_engine, block, hw, B):
    """K5 (int8 wgmma, weights by TMA) at every distinct R50 block shape,
    bit-equal to chunk_reference. B = 3 leaves a partly filled last block
    where a block takes two whole images (layer4's identity blocks, whose
    second 64-row M tile spans the boundary between them); B = 128, the
    serving batch, at layer4 and at the first block of layer1 and layer2."""
    from tpupose_torch.ops.cuda_stages import chunk_reference, run_chunk

    blk = int8_engine.blocks[block]
    g = torch.Generator().manual_seed(100 + block + B)
    x = torch.randint(0, 60, (B, *hw, blk.cin), generator=g,
                      dtype=torch.int8).cuda()
    n0 = run_chunk.launches
    got = run_chunk(x, blk)
    assert run_chunk.launches == n0 + 1
    torch.cuda.synchronize()
    want = chunk_reference(x, blk)
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("deconv", [0, 2], ids=["deconv", "fused_final"])
def test_int8_deconv_kernel(int8_engine, deconv):
    """K6, with and without the fused final conv: bit-equal."""
    from tpupose_torch.ops.cuda_head import deconv_reference, run_deconv

    spec = int8_engine.deconvs[deconv]
    hw = {0: (8, 6), 2: (32, 24)}[deconv]
    g = torch.Generator().manual_seed(9 + deconv)
    x = torch.randint(0, 60, (2, *hw, spec.cin), generator=g,
                      dtype=torch.int8).cuda()
    got = run_deconv(x, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, deconv_reference(x, spec))


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("deconv", [0, 1, 2],
                         ids=["deconv0", "deconv1", "deconv2_final"])
def test_int8_deconv_kernel_every_shape(int8_engine, deconv, B):
    """K6 (int8 wgmma on TMA-fed operands) at the three R50 head shapes,
    bit-equal to deconv_reference. A work item is 192 GEMM rows: 4 images
    of deconv0 (B = 1 and 3 leave the last item partly filled), one image
    of deconv1, 8 of deconv2's 32 rows; deconv2 carries the final conv.
    B = 1 has fewer items than the card has SMs, B = 128 more."""
    from tpupose_torch.ops.cuda_head import deconv_reference, run_deconv

    spec = int8_engine.deconvs[deconv]
    hw = {0: (8, 6), 1: (16, 12), 2: (32, 24)}[deconv]
    g = torch.Generator().manual_seed(30 + 3 * deconv + B)
    x = torch.randint(0, 60, (B, *hw, spec.cin), generator=g,
                      dtype=torch.int8).cuda()
    n0 = run_deconv.launches
    got = run_deconv(x, spec)
    assert run_deconv.launches == n0 + 1
    torch.cuda.synchronize()
    want = deconv_reference(x, spec)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want), int((got != want).sum())


def test_int8_deconv_rejects_what_it_does_not_take(int8_engine):
    import dataclasses

    from tpupose_torch.ops.cuda_head import run_deconv

    spec = int8_engine.deconvs[1]
    x = torch.zeros((1, 16, 12, 256), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="int8"):
        run_deconv(x.float(), spec)
    with pytest.raises(ValueError, match="int8"):
        run_deconv(x[..., :128].contiguous(), spec)
    with pytest.raises(ValueError, match="width"):
        run_deconv(x.new_zeros((1, 2, 200, 256)), spec)
    with pytest.raises(ValueError, match="mv must be"):
        run_deconv(x, dataclasses.replace(spec, mv=spec.mv.cpu()))


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _warp_mats(n, h, w, seed, max_deg=60.0):
    """Seeded dst->src matrices: rotation up to +-max_deg, scale 0.65-1.35
    about the image centre, so parts of the views fall outside."""
    rs = np.random.RandomState(seed)
    th = np.deg2rad(rs.uniform(-max_deg, max_deg, n))
    mu = rs.uniform(0.65, 1.35, n)
    A = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2) * mu[:, None,
                                                                  None]
    c = np.array([w / 2, h / 2])
    t = c - A @ c
    return torch.from_numpy(np.concatenate([A, t[..., None]], -1)
                            .astype(np.float32))


def _assert_warp_equal(got, want):
    """K7 computes the plain version's float32 operations in its order
    (no FMA contraction): every element equal."""
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = (got - want).abs()
    assert int((diff > 0).sum()) == 0, (int((diff > 0).sum()),
                                        diff.max().item())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("out_size", [(64, 48), (20, 36), (37, 29)],
                         ids=["same", "rect_downscale", "ho_not_mult_8"])
def test_warp_kernel(gpu, dtype, out_size):
    """K7 against its plain version: uint8 and float32 sources, the input
    size, a rectangular downscale, and an output height that is not a
    multiple of 8 (the TPU kernel's tile rule does not apply)."""
    from tpupose_torch.ops.affine import batched_affine_warp
    from tpupose_torch.ops.cuda_warp import affine_warp

    g = torch.Generator().manual_seed(11)
    src = torch.randint(0, 256, (5, 64, 48, 3), generator=g,
                        dtype=torch.uint8)
    if dtype == torch.float32:
        src = src.float() + torch.rand(src.shape, generator=g)
    src, m = src.to(gpu), _warp_mats(5, 64, 48, seed=12).to(gpu)
    n0 = affine_warp.launches
    got = affine_warp(src, m, out_size)
    assert affine_warp.launches == n0 + 1
    _assert_warp_equal(got, batched_affine_warp(src, m, out_size))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_warp_kernel_r50_train_batch(gpu, dtype):
    """K7 at the R50 train step's shape, (128, 256, 192, 3), under
    rotations up to +-60 degrees and scales 0.65-1.35: every element equal
    to the plain version's."""
    from tpupose_torch.ops.affine import batched_affine_warp
    from tpupose_torch.ops.cuda_warp import affine_warp

    g = torch.Generator().manual_seed(31)
    src = torch.randint(0, 256, (128, 256, 192, 3), generator=g,
                        dtype=torch.uint8)
    if dtype == torch.float32:
        src = src.float() + torch.rand(src.shape, generator=g)
    src, m = src.to(gpu), _warp_mats(128, 256, 192, seed=32).to(gpu)
    gathered = torch.zeros(1, dtype=torch.int32, device=gpu)
    got = affine_warp(src, m, (256, 192), gather_count=gathered)
    _assert_warp_equal(got, batched_affine_warp(src, m, (256, 192)))
    if dtype == torch.uint8:       # every uint8 footprint fits shared memory
        assert int(gathered.item()) == 0


def test_warp_kernel_crops_480x640_d4(gpu):
    """crops_from_frames at the serving shape: 32 frames of 480x640, D = 4
    person crops each (box heights 150-450 px) -> 128 crops of 256x192,
    every element equal."""
    from tpupose_torch.ops.affine import get_affine_matrix
    from tpupose_torch.ops.cuda_warp import _plain_crops, crops_from_frames

    g = torch.Generator().manual_seed(33)
    frames = torch.randint(0, 256, (32, 480, 640, 3), generator=g,
                           dtype=torch.uint8).to(gpu)
    hgt = 150 + 300 * torch.rand(128, generator=g)
    centers = torch.stack([80 + 480 * torch.rand(128, generator=g),
                           80 + 320 * torch.rand(128, generator=g)], -1)
    m = get_affine_matrix(centers, torch.stack([hgt * 192 / 256, hgt], -1),
                          0.0, (256, 192)).to(gpu)
    got = crops_from_frames(frames, m, (256, 192))
    _assert_warp_equal(got, _plain_crops(frames, m, (256, 192)))


@pytest.mark.parametrize("out_size", [(23, 33), (17, 7), (5, 1)],
                         ids=["wo33", "wo7", "wo1"])
def test_warp_kernel_ragged_tiles(gpu, out_size):
    """Output sizes that cut the kernel's 64 x 32 tiles and 32-pixel row
    segments, with Wo * C not a multiple of 4 (rows start off a 16-byte
    boundary, so the 16-byte stores give way to the tail's scalar ones):
    every element equal."""
    from tpupose_torch.ops.affine import batched_affine_warp
    from tpupose_torch.ops.cuda_warp import affine_warp

    g = torch.Generator().manual_seed(34)
    src = torch.randint(0, 256, (4, 40, 36, 3), generator=g,
                        dtype=torch.uint8).to(gpu)
    m = _warp_mats(4, 40, 36, seed=35).to(gpu)
    assert (out_size[1] * 3) % 4
    _assert_warp_equal(affine_warp(src, m, out_size),
                       batched_affine_warp(src, m, out_size))


def test_warp_kernel_extreme_zoom_out(gpu):
    """A zoom-out by 6-8x (a tile's footprint far larger than shared
    memory, so its taps are gathered from device memory) and a view partly
    outside the image: every element equal, and the gather counter counts
    the tiles that took that path."""
    from tpupose_torch.ops.affine import batched_affine_warp
    from tpupose_torch.ops.cuda_warp import affine_warp

    g = torch.Generator().manual_seed(36)
    src = torch.randint(0, 256, (2, 600, 500, 3), generator=g,
                        dtype=torch.uint8).to(gpu)
    m = torch.tensor([[[8.0, 0.0, 3.0], [0.0, 8.0, 1.0]],
                      [[6.0, 3.0, -50.0], [-3.0, 6.0, 200.0]]],
                     device=gpu)
    gathered = torch.zeros(1, dtype=torch.int32, device=gpu)
    got = affine_warp(src, m, (70, 64), gather_count=gathered)
    _assert_warp_equal(got, batched_affine_warp(src, m, (70, 64)))
    assert int(gathered.item()) > 0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("C", [1, 4, 5])
def test_warp_kernel_channels(gpu, dtype, C):
    """Other channel counts than RGB: one and four (16-byte stores of 8 C
    floats a warp) and five (two passes of four and one channel, stored a
    float at a time): every element equal."""
    from tpupose_torch.ops.affine import batched_affine_warp
    from tpupose_torch.ops.cuda_warp import affine_warp

    g = torch.Generator().manual_seed(40 + C)
    src = torch.randint(0, 256, (3, 72, 80, C), generator=g,
                        dtype=torch.uint8)
    if dtype == torch.float32:
        src = src.float() + torch.rand(src.shape, generator=g)
    src, m = src.to(gpu), _warp_mats(3, 72, 80, seed=41).to(gpu)
    _assert_warp_equal(affine_warp(src, m, (70, 96)),
                       batched_affine_warp(src, m, (70, 96)))


def test_warp_kernel_view_fully_outside(gpu):
    from tpupose_torch.ops.cuda_warp import affine_warp

    src = torch.full((2, 16, 16, 3), 200, dtype=torch.uint8, device=gpu)
    m = torch.tensor([[[1.0, 0.0, 100.0], [0.0, 1.0, 100.0]]] * 2,
                     device=gpu)
    got = affine_warp(src, m, (16, 16))
    torch.cuda.synchronize()
    assert got.abs().max().item() == 0.0


def test_warp_kernel_crops_from_frames(gpu):
    """D=3 crops per frame: crop n reads frame n // 3."""
    from tpupose_torch.ops.cuda_warp import _plain_crops, crops_from_frames

    g = torch.Generator().manual_seed(13)
    frames = torch.randint(0, 256, (2, 48, 64, 3), generator=g,
                           dtype=torch.uint8).to(gpu)
    m = _warp_mats(6, 48, 64, seed=14).to(gpu)
    n0 = crops_from_frames.launches
    got = crops_from_frames(frames, m, (32, 24))
    assert crops_from_frames.launches == n0 + 1
    _assert_warp_equal(got, _plain_crops(frames, m, (32, 24)))


def test_warp_kernel_non_contiguous_input(gpu):
    """A non-contiguous source is made contiguous before the launch (see
    the ops/cuda_warp docstring): same result as the contiguous copy."""
    from tpupose_torch.ops.affine import batched_affine_warp
    from tpupose_torch.ops.cuda_warp import affine_warp

    g = torch.Generator().manual_seed(15)
    nchw = torch.randint(0, 256, (3, 3, 40, 32), generator=g,
                         dtype=torch.uint8).to(gpu)
    src = nchw.permute(0, 2, 3, 1)                 # NHWC view, strided
    assert not src.is_contiguous()
    m = _warp_mats(3, 40, 32, seed=16).to(gpu)
    _assert_warp_equal(affine_warp(src, m, (40, 32)),
                       batched_affine_warp(src.contiguous(), m, (40, 32)))


def _qkv_views(B, L, heads, seed, gpu):
    """q, k, v as RopeAttention cuts them from one (B, L, 3*heads*64)
    projection: non-contiguous (B, L, heads, 64) views."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, L, 3 * heads * 64), generator=g) \
        .to(gpu, torch.bfloat16)
    return qkv.view(B, L, 3, heads, 64).unbind(2)


@pytest.mark.parametrize("with_lse", [False, True], ids=["serve", "lse"])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129, 197, 1605])
def test_flash_attention_kernel(gpu, L, with_lse):
    """K8 against the plain version (float32 softmax on the same bf16
    inputs) on strided views, B*heads > 1, with the null-LSE serving
    instantiation and with the LSE store. Tolerance 2e-2 absolute, the
    bf16 bound of tests/test_fused_attention.py::test_jit_and_vit_shapes:
    the kernel rounds P to bf16 before the PV product and the output to
    bf16; the LSE within 1e-3 of torch.logsumexp of the float32 scores
    (over ln 2: the kernel's log2 domain). L around 64 and 128 puts the
    ragged edge of the key tiles and of the two warpgroups' query tiles in
    every position; 1605 is the DINOv3 shape."""
    from tpupose_torch.ops.attention import attention_reference
    from tpupose_torch.ops.cuda_attention import _launch, flash_attention

    B, heads = (2, 3) if L > 200 else (3, 2)
    q, k, v = _qkv_views(B, L, heads, seed=20 + L, gpu=gpu)
    assert not q.is_contiguous()
    n0 = flash_attention.launches
    if with_lse:
        got, lse = _launch(q, k, v, 0.125, True)
    else:
        got = flash_attention(q, k, v, 0.125)
    assert flash_attention.launches == n0 + 1
    torch.cuda.synchronize()
    want = attention_reference(q, k, v, 0.125)
    assert got.shape == (B, L, heads, 64) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    if with_lse:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.125
        want_lse = torch.logsumexp(s, dim=-1) / 0.6931471805599453
        assert lse.shape == (B, heads, L)
        assert (lse - want_lse).abs().max().item() <= 1e-3


def test_fused_attention_on_the_card_goes_to_the_kernel(gpu):
    from tpupose_torch.ops.attention import attention_reference, \
        fused_attention
    from tpupose_torch.ops.cuda_attention import flash_attention

    q, k, v = (t.contiguous() for t in _qkv_views(2, 37, 2, 30, gpu))
    n0 = flash_attention.launches
    got = fused_attention(q, k, v)
    assert flash_attention.launches == n0 + 1
    plain = fused_attention(q, k, v, impl="plain")
    assert flash_attention.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(plain, attention_reference(q, k, v, 0.125))
    assert (got.float() - plain.float()).abs().max().item() <= 2e-2


def test_flash_attention_rejects_what_it_does_not_take(gpu):
    from tpupose_torch.ops.attention import fused_attention

    q = torch.randn((2, 17, 2, 64), device=gpu)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention(q, q, q)                           # float32
    q48 = torch.randn((2, 17, 2, 48), device=gpu, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim must be 64, got 48"):
        fused_attention(q48, q48, q48)


def _rel_max(got, want):
    """max |got - want| over max |want| (at least 1e-3: at L = 1 the
    softmax is constant and dq, dk are 0 up to rounding), in float32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-3)).item()


@pytest.mark.parametrize("L", [1, 63, 64, 65, 197, 1605])
def test_flash_attention_backward_kernel(gpu, L):
    """K8b against the plain backward (float32 on the same bf16 inputs) on
    strided q/k/v views, and K8's log-sum-exp against torch.logsumexp of
    the float32 scores. Tolerances: each of dq, dk, dv within 2e-2 of the
    max |reference gradient| (the kernel rounds P and dS to bf16 before
    its products, as the forward rounds P); the LSE within 1e-3 (float32
    sums in another order, exp2/log2 instead of exp/log). L = 1, 63, 64,
    65 and 197 put the padded query and key rows of the last tile in
    every position; 1605 is the DINOv3 shape."""
    from tpupose_torch.ops.attention import attention_backward_reference
    from tpupose_torch.ops.cuda_attention import (_launch,
                                                  flash_attention_backward)

    B, heads = (2, 3) if L > 200 else (3, 2)
    q, k, v = _qkv_views(B, L, heads, seed=40 + L, gpu=gpu)
    g = torch.Generator().manual_seed(50 + L)
    do = torch.randn((B, L, heads, 64), generator=g).to(gpu, torch.bfloat16)
    o, lse = _launch(q, k, v, 0.125, True)
    n0 = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, o, lse, do, 0.125)
    assert flash_attention_backward.launches == n0 + 1
    torch.cuda.synchronize()
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        do.float(), 0.125)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (B, L, heads, 64) and a.dtype == torch.bfloat16
        assert torch.isfinite(a.float()).all(), name
        assert _rel_max(a, w) <= 2e-2, (name, _rel_max(a, w))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.125
    want_lse = torch.logsumexp(s, dim=-1) / 0.6931471805599453   # log2
    assert lse.shape == (B, heads, L)
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("L", [197, 1605])
def test_flash_attention_backward_is_deterministic(gpu, L):
    """K8b has no float atomics and sums in a fixed order: two calls on the
    same inputs give the same bits (activation checkpointing relies on
    it)."""
    from tpupose_torch.ops.cuda_attention import (_launch,
                                                  flash_attention_backward)

    B, heads = (2, 3) if L > 200 else (8, 6)
    q, k, v = _qkv_views(B, L, heads, seed=60 + L, gpu=gpu)
    g = torch.Generator().manual_seed(70 + L)
    do = torch.randn((B, L, heads, 64), generator=g).to(gpu, torch.bfloat16)
    o, lse = _launch(q, k, v, 0.125, True)
    first = flash_attention_backward(q, k, v, o, lse, do, 0.125)
    second = flash_attention_backward(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("B", [5, 20], ids=["support", "query"])
def test_fused_attention_at_fskd_shapes(gpu, B):
    """K8 and K8b through fused_attention's autograd at FSKD ViT-S 224's
    (B, 201, 6, 64) (5 support or 20 query crops), q and k contiguous and
    v a strided view of the qkv projection as RopeAttention hands them:
    o, dq, dk, dv each within 2e-2 of the max |float32 plain| (the bf16
    bound of the tests above); values one token off read far above it."""
    from tpupose_torch.ops.attention import (attention_reference,
                                             fused_attention)

    g = torch.Generator().manual_seed(80 + B)
    qkv = torch.randn((B, 201, 3 * 6 * 64), generator=g) \
        .to(gpu, torch.bfloat16).requires_grad_()
    do = torch.randn((B, 201, 6, 64), generator=g).to(gpu, torch.bfloat16)
    f32 = qkv.detach().float().requires_grad_()

    def run(src, roll=0):
        q, k, v = src.view(B, 201, 3, 6, 64).unbind(2)
        v_ = v.roll(roll, 1) if roll else v
        out = (attention_reference(q, k, v_, 0.125) if src is f32
               else fused_attention(q.contiguous(), k.contiguous(), v_))
        (d,) = torch.autograd.grad(out, src, do.to(out.dtype))
        return (out, *d.view(B, 201, 3, 6, 64).unbind(2))

    want = run(f32)
    for name, a, w in zip(("o", "dq", "dk", "dv"), run(qkv), want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_max(a, w) <= 2e-2, (name, _rel_max(a, w))
    for name, a, w in zip(("o", "dq", "dk", "dv"), run(f32, roll=1), want):
        assert _rel_max(a, w) > 0.1, (name, _rel_max(a, w))


def test_fused_attention_backward_on_the_card_goes_to_k8b(gpu):
    """autograd through fused_attention on CUDA tensors: K8 saves its LSE
    and the backward is one K8b launch; the gradients agree with autograd
    of the plain version on the same inputs (2e-2 of the max gradient).
    Without gradients K8 computes no LSE and K8b is never reached."""
    from tpupose_torch.ops.attention import fused_attention
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)

    qkv = torch.randn((2, 37, 3 * 2 * 64), device=gpu, dtype=torch.bfloat16,
                      requires_grad=True)
    q, k, v = qkv.view(2, 37, 3, 2, 64).unbind(2)
    do = torch.randn((2, 37, 2, 64), device=gpu, dtype=torch.bfloat16)
    n0, b0 = flash_attention.launches, flash_attention_backward.launches
    (g_kernel,) = torch.autograd.grad(fused_attention(q, k, v), qkv, do)
    assert flash_attention.launches == n0 + 1
    assert flash_attention_backward.launches == b0 + 1
    (g_plain,) = torch.autograd.grad(fused_attention(q, k, v, impl="plain"),
                                     qkv, do)
    assert flash_attention_backward.launches == b0 + 1
    torch.cuda.synchronize()
    assert _rel_max(g_kernel, g_plain) <= 2e-2
    with torch.no_grad():
        fused_attention(q, k, v)
    assert flash_attention_backward.launches == b0 + 1


def test_vit_remat_on_the_card(gpu):
    """A bf16 two-block DinoViT's gradients through K8/K8b with its blocks
    checkpointed (remat) equal those without, bit for bit (K8 and K8b are
    deterministic); with remat a step launches K8 twice per block and K8b
    once."""
    from tpupose_torch.models.backbones.vit import DinoViT
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)

    torch.manual_seed(0)
    vit = DinoViT(depth=2, dim=128, heads=2).to(gpu, torch.bfloat16)
    for blk in vit.blocks:
        torch.nn.init.uniform_(blk.ls1.gamma, 0.2, 0.6)
        torch.nn.init.uniform_(blk.ls2.gamma, 0.2, 0.6)
    x = torch.randn((2, 64, 48, 3), device=gpu, dtype=torch.bfloat16)
    grads = {}
    for remat in (False, True):
        vit.remat = remat
        vit.zero_grad()
        n0, b0 = flash_attention.launches, flash_attention_backward.launches
        xi = x.clone().requires_grad_()
        vit(xi)["feature_map"].float().square().sum().backward()
        assert flash_attention.launches - n0 == (4 if remat else 2)
        assert flash_attention_backward.launches - b0 == 2
        grads[remat] = [xi.grad] + [p.grad for p in vit.parameters()]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_k2_k5_k6_launch_on_a_second_card_after_the_first(card,
                                                          int8_engine):
    """K2, K5 and K6 key their launch setup (the shared-memory limit, the
    SM or cluster count) by device: after launches on cuda:0 they launch
    on cuda:1 too, and agree with their plain versions there. Needs two
    cards (skips on one)."""
    import copy

    from tpupose_torch.ops.cuda_engine import CudaServingEngine
    from tpupose_torch.ops.cuda_head import deconv_reference, run_deconv
    from tpupose_torch.ops.cuda_layer1 import (fold_layer1_weights, layer1,
                                               layer1_reference)
    from tpupose_torch.ops.cuda_stages import chunk_reference, run_chunk

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    imgs = np.random.RandomState(4).randint(0, 256, (2, 256, 192, 3)) \
        .astype(np.uint8)
    g = torch.Generator().manual_seed(31)
    x = torch.rand((2, 64, 48, 64), generator=g).to(torch.bfloat16)
    x5 = torch.randint(0, 60, (2, 64, 48, 64), generator=g, dtype=torch.int8)
    x6 = torch.randint(0, 60, (2, 8, 6, int8_engine.deconvs[0].cin),
                       generator=g, dtype=torch.int8)
    outs = {}
    for dev in ("cuda:0", "cuda:1"):
        model = card if dev == "cuda:0" else copy.deepcopy(card).to(dev)
        eng = (int8_engine if dev == "cuda:0"
               else CudaServingEngine.build(model, imgs, device=dev))
        w = fold_layer1_weights(model.backbone)
        xd, x5d, x6d = x.to(dev), x5.to(dev), x6.to(dev)
        outs[dev] = (layer1(xd, w), run_chunk(x5d, eng.blocks[0]),
                     run_deconv(x6d, eng.deconvs[0]))
        torch.cuda.synchronize(dev)
        assert all(o.device == torch.device(dev) for o in outs[dev])
        assert _rel(outs[dev][0], layer1_reference(xd, w)) < 2e-2
        assert torch.equal(outs[dev][1], chunk_reference(x5d, eng.blocks[0]))
        assert torch.equal(outs[dev][2],
                           deconv_reference(x6d, eng.deconvs[0]))
    for a, b in zip(outs["cuda:0"], outs["cuda:1"]):
        assert torch.equal(a.cpu(), b.cpu())


def test_evaluate_kernel_route_matches_the_plain_route(card, tmp_path):
    """Trainer.evaluate() of the simple_baseline config (R50 256x192, flip)
    on the kernel route (K1-K4) against the same evaluator with the fast
    route off (the model's own autocast forward): every PCK and OKS-AP
    number within 0.005 (the 0.5-pt gate of
    tests/test_int8_metric_parity.py), and per flip eval batch 2 K1, 6 K2,
    2 K3 and 1 K4 launches. On 2048 synthetic crops: an untrained model's
    heatmaps have no clear peak, the two bf16 routes' rounding moves ~12%
    of the argmaxes both ways, and the net PCK difference scatters by
    ~0.004 on 64 crops, ~0.0008 on 2048."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.trainer import Trainer
    from tpupose_torch.ops.cuda_bridge import bridge
    from tpupose_torch.ops.cuda_decode import dark_decode
    from tpupose_torch.ops.cuda_layer1 import layer1
    from tpupose_torch.ops.cuda_stem import stem_pool

    cfg = load_config("tpupose/configs/method/simple_baseline.yaml", {
        "train.output_dir": str(tmp_path), "eval.run_metrics": "true"})
    tr = Trainer(cfg, device="cuda")
    tr.valid_ds = SyntheticTopDownDataset(2048, (256, 192), (64, 48), 17,
                                          seed=1)
    tr.valid_loader = tr.builder.dataloader(tr.valid_ds, "valid")
    tr.valid_loader = list(tr._eval_batches())      # rendered once
    wrappers = (stem_pool, layer1, bridge, dark_decode)
    for w in wrappers:
        w.launches = 0
    got = tr.evaluate()
    n = len(tr.valid_loader)
    assert [w.launches for w in wrappers] == [2 * n, 6 * n, 2 * n, n]
    tr._evaluator.fast_r50 = False
    want = tr.evaluate()
    assert tr._evaluator.fast_weights is None
    for k in ("pck", "mAP", "mAP50", "mAP75"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 0.005, k


# -- HRNet and the int8 engine without hand kernels (no TPU kernel in JAX
# either: cuDNN convolutions and torch._int_mm products) ----------------------

@pytest.mark.parametrize("blur,sigma,hw", [(11, 2.0, (64, 48)),
                                           (17, 3.0, (96, 72))],
                         ids=["w32_64x48", "w48_96x72"])
def test_dark_decode_kernel_at_hrnet_shapes(gpu, blur, sigma, hw):
    """K4 at the two HRNet heatmap sizes with their blur (W48: 17 taps,
    sigma 3) on Gaussian maps of that sigma: coordinates within 1e-3 px,
    scores equal."""
    from tpupose_torch.ops.cuda_decode import (dark_decode,
                                               dark_decode_reference)

    g = torch.Generator().manual_seed(3)
    B, K = 64, 17
    mu = torch.rand((B, K, 2), generator=g) * torch.tensor(
        [hw[1] - 4.0, hw[0] - 4.0]) + 2.0
    ys = torch.arange(hw[0], dtype=torch.float32)[:, None]
    xs = torch.arange(hw[1], dtype=torch.float32)[None, :]
    hm = torch.exp(-((xs - mu[..., 0, None, None]) ** 2
                     + (ys - mu[..., 1, None, None]) ** 2)
                   / (2 * sigma ** 2)).cuda()
    c, s = dark_decode(hm, blur, sigma)
    rc, rs = dark_decode_reference(hm, blur, sigma)
    assert torch.equal(s, rs)
    assert (c - rc).abs().max().item() <= 1e-3


def test_hrnet_forward_on_the_card_matches_the_cpu(gpu):
    """HRNet-W32 at 256x192 in float32 (TF32 off): the card's heatmaps
    within 1e-4 of the CPU's range (cuDNN and the CPU sum in other
    orders)."""
    from tpupose_torch.models.backbones.hrnet import HRNetPose

    torch.backends.cudnn.allow_tf32 = False
    m = HRNetPose("hrnet_w32", 17, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    x = torch.randn((2, 256, 192, 3), generator=torch.Generator()
                    .manual_seed(5))
    with torch.no_grad():
        want = m(x)
        got = m.cuda()(x.cuda()).cpu()
    assert _rel(got, want) < 1e-4


def test_int8_engine_on_the_card_equals_the_cpu(gpu):
    """The Int8Engine of HRNet-W48 at 384x288 built on the card, and the
    same engine (nodes, int8 weights, scales) run on the CPU: equal in
    every element (exact int32 products, the same float32 epilogues)."""
    from tpupose_torch.models.backbones.hrnet import HRNetPose
    from tpupose_torch.ops.int8_engine import Int8Engine

    m = HRNetPose("hrnet_w48", 17, dtype=torch.float32, device="cuda",
                  generator=torch.Generator().manual_seed(6))
    crops = torch.randint(0, 256, (4, 384, 288, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(7))
    eng = Int8Engine.build(m, calib=crops, device="cuda")
    cpu = Int8Engine(eng._nodes, {k: tuple(t.cpu() for t in v)
                                  for k, v in eng._qw.items()},
                     eng._scales, eng._pad, eng._in_pad, device="cpu")
    got = eng(crops[:2])
    assert got.is_cuda and got.shape == (2, 96, 72, 17)
    assert torch.equal(got.cpu(), cpu(crops[:2]))


def test_ptq_on_the_card_under_autocast(gpu):
    """The PTQ intercept on an R50 with float32 masters under bf16
    autocast: int8 layers give the autocast dtype, the float32 head stays
    float32, and the heatmaps stay within the int8 bounds of
    tests/test_pallas_engine.py (max rel 0.15, mean rel 0.02) of the
    model's own forward; every forward is restored."""
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops.preprocess import normalize_images
    from tpupose_torch.ops.quant import quantized_apply

    m = SimpleBaseline("resnet50", 17, dtype=torch.bfloat16, device="cuda",
                       param_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(8))
    crops = torch.randint(0, 256, (8, 256, 192, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(9)).cuda()
    scales = HeatmapPredictor.calibrate_int8(m, crops)
    x = normalize_images(crops).float()
    with torch.no_grad():
        want = m(x).float()
    got = quantized_apply(m, scales, x)
    assert got.dtype == torch.float32
    d = (got - want).abs()
    den = want.abs().max()
    assert (d.max() / den).item() < 0.15 and (d.mean() / den).item() < 0.02
    assert not any("forward" in vars(mod) for mod in m.modules())


def _vitb_detector():
    """DINOv3Pose ViT-B/16 at 640x640 (dinov3_vitpose.yaml) through the
    Builder, with layer scales drawn in U(0.2, 0.6) so attention shows in
    the output (flax's 1e-5 makes every block nearly the identity)."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.models.backbones.vit import LayerScale

    cfg = load_config("tpupose/configs/method/dinov3_vitpose.yaml")
    model = Builder(cfg, "cuda").model()
    g = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.copy_(torch.empty(m.gamma.shape).uniform_(
                    0.2, 0.6, generator=g))
    return model


def test_dinov3_vitb_640_forward_k8_against_plain_attention(gpu):
    """The detector's decoded output on the K8 route (12 launches a
    forward) against plain attention, piece by piece: within 0.06 of each
    piece's max |value| and 5e-3 on average (the ViTPose bound)."""
    from tpupose_torch.ops.cuda_attention import flash_attention
    from tpupose_torch.ops.preprocess import normalize_images

    model = _vitb_detector()
    g = torch.Generator().manual_seed(16)
    x = normalize_images(torch.randint(0, 256, (2, 640, 640, 3), generator=g,
                                       dtype=torch.uint8).to(gpu),
                         scale_only=True)
    with torch.no_grad():
        n0 = flash_attention.launches
        got = model(x).float()
        assert flash_attention.launches == n0 + 12
        for m in model.modules():
            if hasattr(m, "impl"):
                m.impl = "plain"
        want = model(x).float()
    assert got.shape == (2, 8400, 7 + 12) and torch.isfinite(got).all()
    kp_g, kp_w = got[..., 7:].reshape(2, -1, 4, 3), \
        want[..., 7:].reshape(2, -1, 4, 3)
    for a, b in ((got[..., :7], want[..., :7]),
                 (kp_g[..., :2], kp_w[..., :2]),
                 (kp_g[..., 2], kp_w[..., 2])):
        den = b.abs().max().clamp_min(1e-12)
        assert ((a - b).abs().max() / den).item() < 0.06
        assert ((a - b).abs().mean() / den).item() < 5e-3


def test_person_crops_on_k7_equal_the_plain_crops(gpu):
    """person_crops at the video path's shape (8 frames of 640x640, 16
    boxes each, invalid slots on the safe box) on K7, bit-equal to the
    plain crops of the same matrices."""
    from tpupose_torch.engine.two_stage import person_crops
    from tpupose_torch.ops.affine import get_affine_matrix
    from tpupose_torch.ops.cuda_warp import _plain_crops, crops_from_frames

    g = torch.Generator().manual_seed(17)
    frames = torch.randint(0, 256, (8, 640, 640, 3), generator=g,
                           dtype=torch.uint8).to(gpu)
    xy = torch.rand((8, 16, 2), generator=g) * 560
    wh = torch.rand((8, 16, 2), generator=g) * 300 + 8
    boxes = torch.cat([xy, xy + wh], -1).to(gpu)
    valid = (torch.rand((8, 16), generator=g) > 0.3).to(gpu)
    n0 = crops_from_frames.launches
    crops, center, scale = person_crops(frames, boxes, valid, (256, 192))
    assert crops_from_frames.launches == n0 + 1
    mats = get_affine_matrix(center, scale, 0.0, (256, 192))
    _assert_warp_equal(crops, _plain_crops(frames, mats, (256, 192)))


def test_two_stage_step_launches_exactly(gpu):
    """One two-stage chunk (8 frames, D = 16) on the R50 256x192 config:
    exactly 1 K7, 1 K1, 3 K2, 1 K3 and 1 K4 launch, and no K5, K6, K8 or
    K8b; then the detector chained in front adds exactly 12 K8."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.predictor import YoloPosePredictor
    from tpupose_torch.engine.two_stage import TwoStagePosePredictor
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)
    from tpupose_torch.ops.cuda_bridge import bridge
    from tpupose_torch.ops.cuda_decode import dark_decode
    from tpupose_torch.ops.cuda_head import run_deconv
    from tpupose_torch.ops.cuda_layer1 import layer1
    from tpupose_torch.ops.cuda_stages import run_chunk
    from tpupose_torch.ops.cuda_stem import stem_pool
    from tpupose_torch.ops.cuda_warp import affine_warp, crops_from_frames

    counters = {"K7": crops_from_frames, "K1": stem_pool, "K2": layer1,
                "K3": bridge, "K4": dark_decode, "K5": run_chunk,
                "K6": run_deconv, "K8": flash_attention,
                "K8b": flash_attention_backward, "warp": affine_warp}
    cfg = load_config("tpupose/configs/method/simple_baseline.yaml")
    two = TwoStagePosePredictor(Builder(cfg, "cuda").model(), (256, 192),
                                (64, 48), max_persons=16,
                                detector=YoloPosePredictor(
                                    _vitb_detector(), 7, 4,
                                    conf_threshold=0.005))
    g = torch.Generator().manual_seed(18)
    frames = torch.randint(0, 256, (8, 640, 640, 3), generator=g,
                           dtype=torch.uint8).to(gpu)
    boxes = torch.tensor([[[40.0 + 30 * j, 60.0, 220.0 + 20 * j, 600.0]
                           for j in range(16)]] * 8, device=gpu)
    valid = torch.ones((8, 16), dtype=torch.bool, device=gpu)
    two._pose_step(frames, boxes, valid)            # builds and warms up
    torch.cuda.synchronize()
    before = {k: c.launches for k, c in counters.items()}
    coords, scores = two._pose_step(frames, boxes, valid)
    torch.cuda.synchronize()
    got = {k: c.launches - before[k] for k, c in counters.items()}
    assert got == {"K7": 1, "K1": 1, "K2": 3, "K3": 1, "K4": 1, "K5": 0,
                   "K6": 0, "K8": 0, "K8b": 0, "warp": 0}
    assert coords.shape == (8, 16, 17, 2) and torch.isfinite(coords).all()
    before = {k: c.launches for k, c in counters.items()}
    out = two(frames.cpu().numpy())
    got = {k: c.launches - before[k] for k, c in counters.items()}
    assert got == {"K7": 1, "K1": 1, "K2": 3, "K3": 1, "K4": 1, "K5": 0,
                   "K6": 0, "K8": 12, "K8b": 0, "warp": 0}
    assert out["keypoints"].shape == (8, 16, 17, 3)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_dinov3_vit_yolo_train_step_launches_exactly(gpu, frozen):
    """One DINOv3Pose train step (ViT-S backbone, 12 blocks, at 64x64,
    bf16 autocast over float32 masters, pose_compute, AdamW) through
    make_yolo_train_step: exactly 12 K8 launches, and 12 K8b where the
    backbone trains, 0 where it is frozen; finite losses, the frozen
    backbone bit-unchanged and the trained one moved."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.data.synthetic import SyntheticYoloPoseDataset
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_yolo_train_step)
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)

    cfg = load_config("tpupose/configs/method/dinov3_vitpose.yaml", {
        "model.backbone": "dinov3_vit_small",
        "model.neck_channels": [48, 96, 192],
        "model.freeze_backbone": frozen, "data.image_size": [64, 64],
        "train.warmup_epochs": 0})
    b = Builder(cfg, gpu)
    model = b.model()
    state = TrainState(model, b.optimizer(model, 1))
    ds = SyntheticYoloPoseDataset(4, (64, 64), 4, 7, 8)
    batch = {k: torch.from_numpy(np.stack([ds[i][s] for i in range(4)]))
             .to(gpu) for k, s in (("images", "image"), ("boxes", "boxes"),
                                   ("classes", "classes"),
                                   ("keypoints", "keypoints"),
                                   ("instance_mask", "instance_mask"))}
    before = [p.detach().clone() for p in model.backbone.parameters()]
    step = make_yolo_train_step(b.loss())
    n0, b0 = flash_attention.launches, flash_attention_backward.launches
    met = step(state, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches - n0 == 12
    assert flash_attention_backward.launches - b0 == (0 if frozen else 12)
    assert set(met) == {"loss", "grad_norm", "loss_cls", "loss_kpt",
                        "loss_vis"}
    assert all(torch.isfinite(v).all() for v in met.values())
    same = [torch.equal(a, p) for a, p in zip(before,
                                              model.backbone.parameters())]
    assert all(same) if frozen else not all(same)


def test_simcc_train_step_launches_the_warp_once(gpu):
    """One SimCC train step (ResNet-18 at 64x48, bins 128 x 96, bf16
    autocast over float32 masters, device affine and jitter) through
    make_simcc_train_step: exactly one K7 launch, finite loss and grad
    norm."""
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.engine.train_state import (TrainState,
                                                  make_simcc_train_step)
    from tpupose_torch.losses.simcc import simcc_kl_loss
    from tpupose_torch.models.simcc import SimCCPose
    from tpupose_torch.ops.cuda_warp import affine_warp

    model = SimCCPose("resnet18", 4, 2.0, (64, 48), dtype=torch.bfloat16,
                      device=gpu, param_dtype=torch.float32)
    state = TrainState(model, make_optimizer(OptimizerConfig(name="adam"),
                                             model.named_parameters()))
    g = torch.Generator().manual_seed(3)
    batch = {"images": torch.randint(0, 256, (8, 64, 48, 3), generator=g,
                                     dtype=torch.uint8).to(gpu),
             "joints": (torch.rand((8, 4, 2), generator=g)
                        * torch.tensor([96.0, 128.0])).to(gpu),
             "visibility": torch.ones((8, 4), device=gpu)}
    step = make_simcc_train_step(simcc_kl_loss, (128, 96),
                                 color_jitter_strength=0.2,
                                 affine_rotation=30.0, affine_scale=0.25)
    n0 = affine_warp.launches
    met = step(state, batch)
    torch.cuda.synchronize()
    assert affine_warp.launches - n0 == 1
    assert all(torch.isfinite(v).all() for v in met.values())


def test_cli_test_image_launches_k8_exactly(gpu, tmp_path):
    """cli.test on a DINOv3Pose ViT-S config (12 blocks) at 64x64: one
    image, exactly 12 K8 launches, one annotated file."""
    from PIL import Image

    from tpupose_torch.cli.test import run_inference
    from tpupose_torch.configs import load_config
    from tpupose_torch.ops.cuda_attention import flash_attention

    (tmp_path / "in").mkdir()
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (48, 80, 3)).astype(np.uint8)).save(tmp_path / "in" / "a.jpg")
    cfg = load_config("tpupose/configs/method/dinov3_vitpose.yaml", {
        "model.backbone": "dinov3_vit_small",
        "model.neck_channels": [48, 96, 192], "data.image_size": [64, 64],
        "eval.conf_threshold": 0.005})
    n0 = flash_attention.launches
    out = run_inference(cfg, str(tmp_path / "in"), str(tmp_path / "out"),
                        device=gpu)
    torch.cuda.synchronize()
    assert flash_attention.launches - n0 == 12
    assert out["images"] == 1 and (tmp_path / "out" / "a.jpg").exists()


def test_decode_ae_on_the_card_equals_the_cpu(gpu):
    """The AE grouping on the card (CUDA sort, argmin, max-pool) gives the
    CPU's persons on int8-like lattice maps (exact ties) and on random
    ones."""
    from tpupose_torch.ops.ae_decode import decode_ae

    rs = np.random.RandomState(1)
    for hm in ((rs.randint(0, 6, (4, 17, 32, 32)) / 5.0),
               rs.uniform(0, 1, (4, 17, 32, 32))):
        hm = torch.from_numpy(hm.astype(np.float32))
        tg = torch.from_numpy(rs.normal(0, 1, hm.shape).astype(np.float32))
        want = decode_ae(hm, tg, max_people=30)
        got = decode_ae(hm.to(gpu), tg.to(gpu), max_people=30)
        for k in ("coords", "scores", "person_mask"):
            assert torch.equal(got[k].cpu(), want[k]), k
        torch.testing.assert_close(got["person_scores"].cpu(),
                                   want["person_scores"], rtol=1e-6,
                                   atol=0)


# -- training leftovers and detection-box evaluation ---------------------------

def _r18_state(gpu, accum=1, name="adam", seed=3):
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import TrainState
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    model = SimpleBaseline("resnet18", 4, (32, 32, 32), dtype=torch.bfloat16,
                           device=gpu, param_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(OptimizerConfig(name=name, lr=1e-3),
                         model.named_parameters(), grad_clip_norm=10.0,
                         grad_accum_steps=accum)
    return TrainState(model, opt)


def _r18_batch(gpu, seed=4, n=8):
    g = torch.Generator().manual_seed(seed)
    return {"images": torch.randint(0, 256, (n, 64, 64, 3), generator=g,
                                    dtype=torch.uint8).to(gpu),
            "joints": (torch.rand((n, 4, 2), generator=g) * 16).to(gpu),
            "visibility": torch.ones((n, 4), device=gpu)}


def test_distilled_step_launches_the_warp_once(gpu):
    """Two distilled heatmap steps (R18 student, a frozen R18 teacher of
    other weights, bf16 autocast over float32 masters, device affine and
    jitter): exactly one K7 launch a step, finite task and distillation
    losses, the teacher unchanged."""
    from tpupose_torch.engine.train_state import make_heatmap_train_step
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.ops.cuda_warp import affine_warp

    state = _r18_state(gpu)
    teacher = _r18_state(gpu, seed=5).model.eval().requires_grad_(False)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    step = make_heatmap_train_step(
        joints_mse_loss, color_jitter_strength=0.2, heatmap_size=(16, 16),
        affine_rotation=30.0, affine_scale=0.25, teacher=teacher,
        distill_weight=0.5)
    batch = _r18_batch(gpu)
    for _ in range(2):
        n0 = affine_warp.launches
        met = step(state, batch)
        torch.cuda.synchronize()
        assert affine_warp.launches - n0 == 1
        assert {"task_loss", "kd_loss"} <= set(met)
        assert all(torch.isfinite(v).all() for v in met.values())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_accumulation_mini_steps_leave_the_parameters_bit_unchanged(gpu):
    """grad_accum_steps = 3, lamb, 6 device-affine steps: every parameter
    bit-unchanged after mini-steps 1, 2, 4, 5 and changed after 3 and 6;
    one K7 launch a step; the update count 2."""
    from tpupose_torch.engine.train_state import make_heatmap_train_step
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.ops.cuda_warp import affine_warp

    state = _r18_state(gpu, accum=3, name="lamb")
    step = make_heatmap_train_step(joints_mse_loss, heatmap_size=(16, 16),
                                   affine_rotation=30.0, affine_scale=0.25)
    batch = _r18_batch(gpu)
    for t in range(6):
        before = [p.detach().clone() for p in state.model.parameters()]
        n0 = affine_warp.launches
        met = step(state, batch)
        torch.cuda.synchronize()
        assert affine_warp.launches - n0 == 1
        assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
        same = [torch.equal(a, p.detach())
                for a, p in zip(before, state.model.parameters())]
        if (t + 1) % 3:
            assert all(same), t
        else:
            assert not any(same), t
    assert state.optimizer.count == 2 and state.step == 6


def _write_det_set(root, n_images=3, seed=0):
    """A small COCO-format set (480x640 JPEGs, 1-2 persons, 17
    keypoints) and a detection JSON: each GT box jittered plus one false
    positive an image. Returns the detection file."""
    import json

    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    images, anns, dets = [], [], []
    for i in range(n_images):
        name = f"{i:012d}.jpg"
        Image.fromarray(rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)) \
            .save(root / "val2017" / name)
        images.append({"id": i, "file_name": name, "width": 640,
                       "height": 480})
        for _ in range(1 + i % 2):
            x, y, w, h = (float(rng.uniform(0, 400)), float(rng.uniform(0, 200)),
                          150.0, 250.0)
            kp = np.stack([rng.uniform(x, x + w, 17), rng.uniform(y, y + h, 17),
                           np.full(17, 2.0)], 1)
            anns.append({"id": len(anns), "image_id": i, "category_id": 1,
                         "bbox": [x, y, w, h], "keypoints": kp.ravel().tolist(),
                         "num_keypoints": 17, "area": w * h, "iscrowd": 0})
            dets.append({"image_id": i, "category_id": 1, "score": 0.9,
                         "bbox": [x + 5, y - 5, w * 1.05, h * 0.95]})
        dets.append({"image_id": i, "category_id": 1, "score": 0.3,
                     "bbox": [500.0, 300.0, 100.0, 150.0]})
    (root / "annotations" / "person_keypoints_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    (root / "dets.json").write_text(json.dumps(dets))
    return str(root / "dets.json")


def test_det_eval_batch_launches_exactly(card, tmp_path):
    """evaluate_detections of the R50 at 256x192 with flip and DARK on
    the kernel route: per batch exactly 2 K1, 6 K2, 2 K3 and 1 K4
    launches; the AP suite finite."""
    from tpupose_torch.engine.det_eval import (DetectionCropDataset,
                                               evaluate_detections)
    from tpupose_torch.engine.evaluator import TopDownEvaluator
    from tpupose_torch.ops.cuda_bridge import bridge
    from tpupose_torch.ops.cuda_decode import dark_decode
    from tpupose_torch.ops.cuda_layer1 import layer1
    from tpupose_torch.ops.cuda_stem import stem_pool

    det_file = _write_det_set(tmp_path)
    ds = DetectionCropDataset(str(tmp_path / "val2017"), str(
        tmp_path / "annotations" / "person_keypoints_val2017.json"),
        det_file)
    ev = TopDownEvaluator(card, (64, 48), flip_test=True, device="cuda")
    assert ev.fast_weights is not None
    wrappers = (stem_pool, layer1, bridge, dark_decode)
    for w in wrappers:
        w.launches = 0
    out = evaluate_detections(ev, ds, batch_size=4, num_workers=0)
    n = -(-len(ds) // 4)
    assert [w.launches for w in wrappers] == [2 * n, 6 * n, 2 * n, n]
    assert {"mAP", "mAP50", "AR"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())


def test_second_order_backward_through_k8b_raises(gpu):
    """K8b writes its gradients through ctypes into tensors without a
    graph. Where the output gradient itself carries a graph (here through
    `w`; in MAML through the layers after the attention), a second-order
    backward would follow only that path and drop the attention terms
    silently: the backward is once_differentiable and raises instead. The
    first-order gradient with create_graph still runs K8b."""
    from tpupose_torch.ops.attention import fused_attention
    from tpupose_torch.ops.cuda_attention import flash_attention_backward

    g = torch.Generator(device=gpu).manual_seed(16)
    q, k, v, w = (torch.randn((2, 37, 2, 64), device=gpu,
                              dtype=torch.bfloat16,
                              generator=g).requires_grad_()
                  for _ in range(4))
    b0 = flash_attention_backward.launches
    (gq,) = torch.autograd.grad((fused_attention(q, k, v) * w).sum(), q,
                                create_graph=True)
    assert flash_attention_backward.launches == b0 + 1
    with pytest.raises(RuntimeError, match="once_differentiable"):
        (gq.float() ** 2).sum().backward()


def test_fskd_step_and_maml_launch_exactly(gpu):
    """FSKD on ViT-S (bf16 autocast over float32 masters) at 64x64: a
    train step launches K8 24 times (12 blocks, support and query
    encodes) and K8b 24 times; maml_adapt 24 of each an inner step, and a
    backward through its adapted parameters raises (second order through
    K8b)."""
    from torch.func import functional_call

    from tpupose_torch.models.fskd import (FSKD, fskd_episode_loss,
                                           init_fskd_like_flax, maml_adapt)
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)

    model = FSKD(n_way=2, num_keypoints=3, dim=64, vit_size="small",
                 dtype=torch.bfloat16, device="cpu",
                 param_dtype=torch.float32)
    init_fskd_like_flax(model, torch.Generator().manual_seed(0))
    model = model.to(gpu).train()
    g = torch.Generator(device=gpu).manual_seed(17)
    imgs = torch.rand((4, 64, 64, 3), device=gpu, generator=g)
    lbl = torch.tensor([0, 0, 1, 1], device=gpu)
    kpts = torch.rand((4, 3, 2), device=gpu, generator=g)
    vis = torch.full((4, 3), 2.0, device=gpu)
    flash_attention.launches = flash_attention_backward.launches = 0
    loss, _ = fskd_episode_loss(model(imgs, lbl, imgs), lbl, kpts, vis)
    loss.backward()
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (24, 24)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
    model.zero_grad(set_to_none=True)
    flash_attention.launches = flash_attention_backward.launches = 0
    adapted = maml_adapt(model, None, imgs, lbl, kpts, vis, inner_lr=0.01,
                         inner_steps=2)
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (48, 48)
    out = functional_call(model, adapted, (imgs, lbl, imgs))
    outer, _ = fskd_episode_loss(out, lbl, kpts, vis)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        outer.backward()


def test_fcmae_step_launches_no_kernel(gpu):
    """FCMAE (ConvNeXtV2-atto, bf16 autocast) at 64x64: a train step runs
    none of the hand kernels; the loss is finite."""
    from tpupose_torch.models.fcmae import FCMAE, init_fcmae_like_flax
    from tpupose_torch.ops.cuda_attention import (flash_attention,
                                                  flash_attention_backward)
    from tpupose_torch.ops.cuda_warp import affine_warp

    model = FCMAE(size="atto", decoder_dim=64, dtype=torch.bfloat16,
                  device="cpu", param_dtype=torch.float32)
    init_fcmae_like_flax(model, torch.Generator().manual_seed(0))
    model = model.to(gpu).train()
    wrappers = (flash_attention, flash_attention_backward, affine_warp)
    before = [w.launches for w in wrappers]
    g = torch.Generator(device=gpu).manual_seed(18)
    loss, out = model(torch.rand((4, 64, 64, 3), device=gpu, generator=g),
                      generator=g)
    loss.backward()
    assert [w.launches for w in wrappers] == before
    assert torch.isfinite(loss) and out["pred"].dtype == torch.float32


# -- the kernels as torch.library ops, and an exported program --------------------

def test_ops_equal_their_direct_kernel_calls(card):
    """Each op (K1-K4, K8's forward) on card tensors equals its body's
    direct ctypes call bit for bit, and each launch counts once, through
    the op or directly."""
    from tpupose_torch.ops import (cuda_attention, cuda_bridge, cuda_decode,
                                   cuda_layer1, cuda_stem)

    fw = cuda_stem.fold_fast_r50(card)
    g = torch.Generator(device="cuda").manual_seed(17)
    x0 = torch.randn((2, 256, 192, 3), device="cuda", generator=g) \
        .to(torch.bfloat16)
    x1 = torch.randn((2, 64, 48, 64), device="cuda", generator=g) \
        .to(torch.bfloat16)
    x2 = torch.randn((2, 64, 48, 256), device="cuda", generator=g) \
        .to(torch.bfloat16)
    hm = torch.rand((2, 17, 64, 48), device="cuda", generator=g)
    q, k, v = (torch.randn((2, 197, 6, 64), device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    br = fw["bridge"]
    cases = [
        (cuda_stem.stem_pool_op, cuda_stem.stem_pool_impl,
         (x0, fw["stem"]["w"], fw["stem"]["bias"]), cuda_stem.stem_pool, 1),
        (cuda_layer1.layer1_op, cuda_layer1.layer1_impl,
         (x1, cuda_layer1.flatten_layer1(fw["layer1"])), cuda_layer1.layer1,
         3),
        (cuda_bridge.bridge_op, cuda_bridge.bridge_impl,
         (x2, *(br[n] for n in ("w1", "b1", "w2", "b2", "w3", "b3", "wds"))),
         cuda_bridge.bridge, 1),
        (cuda_decode.dark_decode_op, cuda_decode.dark_decode_impl,
         (hm, 11, 2.0), cuda_decode.dark_decode, 1),
        (cuda_attention.flash_attention_op,
         cuda_attention.flash_attention_impl, (q, k, v, 0.125, True),
         cuda_attention.flash_attention, 1)]
    for op, impl, args, wrapper, per_call in cases:
        n0 = wrapper.launches
        got, want = op(*args), impl(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 2 * per_call
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)


def test_loaded_heatmap_program_launches_k1_k4_each_call(card, tmp_path):
    """The R50 256x192 heatmap program (float32 masters under bf16
    autocast, flip, DARK), exported on the card and loaded back: its graph
    calls the four tpupose_torch:: ops, each run launches K1/K2/K3/K4
    exactly 2/6/2/1 times (never at export), and its output is within the
    route's bounds of TopDownEvaluator.step."""
    from tpupose_torch.engine.evaluator import TopDownEvaluator
    from tpupose_torch.engine.exporter import (HeatmapProgram,
                                               export_program, load_program,
                                               program_ops)
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops import cuda_bridge, cuda_decode, cuda_layer1
    from tpupose_torch.ops import cuda_stem

    m = SimpleBaseline("resnet50", 17, dtype=torch.bfloat16, device="cuda",
                       param_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(5))
    ev = TopDownEvaluator(m, (64, 48), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    imgs = torch.randint(0, 256, (4, 256, 192, 3), device="cuda",
                         dtype=torch.uint8, generator=g)
    c = torch.full((4, 2), 100.0, device="cuda")
    s = torch.full((4, 2), 200.0, device="cuda")
    wrappers = (cuda_stem.stem_pool, cuda_layer1.layer1, cuda_bridge.bridge,
                cuda_decode.dark_decode)
    n0 = [w.launches for w in wrappers]
    path = export_program(HeatmapProgram(ev), (imgs, c, s),
                          str(tmp_path / "r50.pt2"))
    assert [w.launches for w in wrappers] == n0
    prog = load_program(path)
    assert sorted(set(program_ops(prog))) == [
        f"tpupose_torch.{n}.default"
        for n in ("bridge", "dark_decode", "layer1", "stem_pool")]
    for _ in range(2):
        n0 = [w.launches for w in wrappers]
        gc, gs = prog(imgs, c, s)
        torch.cuda.synchronize()
        assert [w.launches - n for w, n in zip(wrappers, n0)] == [2, 6, 2, 1]
    wc, ws = ev.step(imgs, c, s)
    assert ((gc - wc).norm(dim=-1) > 1.0).float().mean().item() <= 0.005
    assert (gs - ws).abs().max().item() <= 1e-3


def test_sync_batchnorm_on_the_card_equals_batchnorm(card, tmp_path):
    """SyncBatchNorm2d on the card in a one-rank NCCL group over a
    FileStore: train-mode output, input / weight / bias gradients and the
    running statistics (flax's update) within 1e-4 of the plain
    BatchNorm2d's for a float32 input, 2e-2 for a bf16 input (float32
    weights)."""
    import datetime

    import torch.distributed as dist

    from tpupose_torch.models.backbones.resnet import BatchNorm2d
    from tpupose_torch.parallel.sync_bn import SyncBatchNorm2d

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        g = torch.Generator(device="cuda").manual_seed(8)
        for dtype in (torch.float32, torch.bfloat16):
            x0 = (torch.randn((4, 32, 12, 10), device="cuda", generator=g)
                  * 2 + 0.5).to(dtype).contiguous(
                      memory_format=torch.channels_last)
            c = torch.randn(x0.shape, device="cuda", generator=g).to(dtype)
            out = {}
            for cls in (BatchNorm2d, SyncBatchNorm2d):
                bn = cls(32).cuda().train()
                gw = torch.Generator(device="cuda").manual_seed(9)
                with torch.no_grad():
                    bn.weight.uniform_(0.5, 1.5, generator=gw)
                    bn.bias.uniform_(-0.5, 0.5, generator=gw)
                x = x0.clone().requires_grad_()
                y = bn(x)
                (y.float() * c.float()).sum().backward()
                out[cls.__name__] = (y.float(), x.grad.float(),
                                     bn.weight.grad, bn.bias.grad,
                                     bn.running_mean, bn.running_var)
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            for a, b in zip(out["SyncBatchNorm2d"], out["BatchNorm2d"]):
                assert _rel(a, b) < tol
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_r50_step_over_nccl_equals_model1(tmp_path):
    """The tensor-parallel axis over NCCL, one rank a card: a float32 SGD
    step of the R50 256x192 Trainer at data 1 x model 2 (device affine,
    global B = 8, noise pixels) against one process at model = 1 in a
    one-rank NCCL group (the same DDP and SyncBatchNorm2d arithmetic),
    both held against the step in float64 as chip_smoke.py's phase 21
    holds them: the loss, every gathered gradient and every updated
    tensor within the larger of 4x model = 1's distance from float64 and
    1e-4 of the tensor's largest magnitude plus 1e-6 (1e-5 relative for
    the loss); twice and half model = 1's gradient, and the parameters
    before the update, are refused. Needs two cards (skips on one)."""
    import multiprocessing as mp
    import time

    import torch.distributed as dist

    import torch_dp_worker as worker

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, 2, str(tmp_path / "store_tp"),
                               str(tmp_path), "tp_r50_card"))
             for r in range(2)]
    for p in procs:
        p.start()
    end = time.monotonic() + 400
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung and [p.exitcode for p in procs] == [0, 0]
    tp = torch.load(tmp_path / "tp_r50_card_0.pt", weights_only=False)
    worker.card_group("nccl", 0, 1, str(tmp_path / "store_one"))
    try:
        one = worker.tp_r50_card(str(tmp_path / "one"), model=1)
    finally:
        dist.destroy_process_group()
    hi = worker.tp_r50_card(str(tmp_path / "hi"), model=1, float64=True)

    def worst(got, ones, his):
        return max(float((g - h).abs().max()) / max(
            4.0 * float((o - h).abs().max()),
            1e-4 * float(h.abs().max()) + 1e-6)
            for g, o, h in zip(got, ones, his))

    bound = max(4.0 * abs(one["loss"] - hi["loss"]), 1e-5 * hi["loss"])
    assert abs(tp["loss"] - hi["loss"]) <= bound
    assert worst(tp["grads"], one["grads"], hi["grads"]) <= 1.0
    for x in (2.0, 0.5):
        assert worst([x * g for g in one["grads"]], one["grads"],
                     hi["grads"]) > 1.0
    keys = list(hi["state"])
    states = [[r["state"][k] for k in keys] for r in (tp, one, hi)]
    assert worst(*states) <= 1.0
    assert worst([one["before"][k] for k in keys], *states[1:]) > 1.0


# -- the heatmap train step from a CUDA graph ---------------------------------
#
# Tolerance: a replay launches the kernels the eager step launched, on the
# same tensors, so graphed and eager steps of one update are bit-equal
# (cuDNN held to its deterministic algorithms, so that its choice cannot
# differ between the two). The update itself is not today's eager one:
# the fused update a graph holds computes Adam's bias corrections on the
# card, where the eager foreach one takes them from the host in float64,
# and SGD's step in its own order. Where
# a gradient is near zero, Adam's normalised step turns that rounding into
# a step of the other sign, so against the float update six R50 steps
# agree in their losses to 1e-2 (5e-4 to 2e-3 read on the card, float32
# and bf16), their parameters' change only to 0.05-0.30 in norm; one
# update from the same gradients agrees to 1e-5.

@pytest.fixture
def graph_gpu(gpu):
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield gpu
    torch.backends.cudnn.deterministic = det


def _r50_train_state(gpu, name="adam", ema=0.0, schedule=None):
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.engine.train_state import TrainState
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    model = SimpleBaseline("resnet50", 17, dtype=torch.bfloat16, device=gpu,
                           param_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(3))
    opt = make_optimizer(OptimizerConfig(name=name, lr=1e-3),
                         model.named_parameters(), grad_clip_norm=10.0,
                         schedule=schedule)
    return TrainState(model, opt, ema_decay=ema)


def _r50_batches(gpu, sizes, seed=7):
    g = torch.Generator().manual_seed(seed)
    return [{"images": torch.randint(0, 256, (b, 256, 192, 3), generator=g,
                                     dtype=torch.uint8).to(gpu),
             "joints": (torch.rand((b, 17, 2), generator=g)
                        * torch.tensor([44.0, 60.0]) + 2.0).to(gpu),
             "visibility": (torch.rand((b, 17), generator=g) < 0.85)
             .float().to(gpu) * 2.0} for b in sizes]


def _heatmap_step_fn():
    from tpupose_torch.engine.train_state import make_heatmap_train_step
    from tpupose_torch.losses.heatmap import joints_mse_loss

    return make_heatmap_train_step(
        joints_mse_loss, color_jitter_strength=0.2, heatmap_size=(64, 48),
        affine_rotation=40.0, affine_scale=0.3)


def _train_run(state, batches, monkeypatch=None, graphed=True,
               between=None):
    """Steps over `batches` on the draws of each step's index: through the
    graph, or eagerly (the blocker patched) on the same update, made
    capturable, its schedules filled before each step as the graph path
    fills them. `between(k, state)` runs before step k. Returns (losses,
    grad norms, replay counts a root)."""
    import tpupose_torch.engine.train_state as ts
    from tpupose_torch.utils import trace

    if not graphed:
        monkeypatch.setattr(ts, "graph_blocker", lambda s: "eager")
        state.make_capturable()
    step = _heatmap_step_fn()
    trace._records.clear()
    losses, norms = [], []
    for k, b in enumerate(batches):
        if between is not None:
            between(k, state)
            if not graphed:
                state.make_capturable()
        if not graphed:
            state.load_schedules()
        m = step(state, b, step.draws_for(k, b["images"].shape[0],
                                          b["images"].device))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    if not graphed:
        monkeypatch.undo()
    replays = [r[7].get("train.graph_replay", 0) for r in trace._records
               if r[7] is not None]
    return torch.stack(losses), torch.stack(norms), replays


def _assert_train_states_equal(a, b):
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for x, y in zip(a.ema or [], b.ema or []):
        assert torch.equal(x, y)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.inner.state[p], b.optimizer.inner.state[q]
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)


def _warmup_lr(t):
    return 1e-3 * min(1.0, (t + 1) / 5.0)


@pytest.mark.parametrize("name,ema,schedule", [
    ("adam", 0.0, None), ("adamw", 0.0, _warmup_lr), ("adam", 0.999, None),
    ("nesterov", 0.0, _warmup_lr)], ids=["adam", "adamw_warmup_lr", "ema",
                                         "nesterov_warmup_lr"])
def test_graphed_heatmap_step_equals_eager(graph_gpu, monkeypatch, name, ema,
                                           schedule):
    """Six R50 steps (B = 8, 256x192, bf16 autocast over float32 masters,
    device affine and jitter), the first eager, the second captured, the
    rest replayed, against the same steps eagerly on the same update:
    losses, grad norms, parameters, BatchNorm statistics, the optimizer's
    moments and the EMA bit-equal; the lr a warm-up schedule changes
    across the replays read from the card. Against the float update of
    today's eager step, within the tolerance above."""
    import tpupose_torch.engine.train_state as ts

    batches = _r50_batches(graph_gpu, [8] * 6)
    g = _r50_train_state(graph_gpu, name, ema, schedule)
    got = _train_run(g, batches)
    assert got[2] == [0, 1, 1, 1, 1, 1]
    e = _r50_train_state(graph_gpu, name, ema, schedule)
    want = _train_run(e, batches, monkeypatch, graphed=False)
    assert want[2] == [0] * 6
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_train_states_equal(g, e)
    lr = g.optimizer.inner.param_groups[0]["lr"]
    want_lr = schedule(5) if schedule else 1e-3
    assert float(lr) == pytest.approx(want_lr, rel=1e-7)
    if name != "adam" or ema:
        return
    f = _r50_train_state(graph_gpu, name, ema, schedule)
    monkeypatch.setattr(ts, "graph_blocker", lambda s: "eager")
    step = _heatmap_step_fn()
    losses = torch.stack([
        step(f, b, step.draws_for(k, 8, graph_gpu))["loss"]
        for k, b in enumerate(batches)])
    torch.testing.assert_close(got[0], losses, rtol=1e-2, atol=0)


@pytest.mark.parametrize("name", ["adam", "adamw", "nesterov"])
def test_capturable_update_matches_the_float_update(graph_gpu, name):
    """Three updates of the R50's parameters from the same gradients under
    a warm-up schedule with an EMA of 0.99, made capturable (lr and decay
    read from the card, the fused update) against the float update of the
    eager step: parameters and EMA within 1e-5 relative (rounding alone,
    no network in between)."""
    states = [_r50_train_state(graph_gpu, name, 0.99, _warmup_lr)
              for _ in range(2)]
    states[1].make_capturable()
    g = torch.Generator(device=graph_gpu).manual_seed(11)
    for _ in range(3):
        # in the parameters' memory format, as autograd makes gradients
        grads = [torch.empty_like(p).normal_(generator=g) * 1e-2
                 for p in states[0].model.parameters()]
        for st in states:
            for p, gr in zip(st.model.parameters(), grads):
                p.grad = gr.clone()
            st.load_schedules()
            st.apply_gradients()
    a, b = states
    for x, y in zip(list(a.model.parameters()) + a.ema,
                    list(b.model.parameters()) + b.ema):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-8)


def test_graphed_heatmap_step_batch_shape_change(graph_gpu, monkeypatch):
    """B = 8, 8, then 4, 4 (a second signature: eager, then its own
    graph), then 8 and 4 again (each replays its graph): equal to the
    eager steps bit for bit."""
    sizes = [8, 8, 4, 4, 8, 4]
    batches = _r50_batches(graph_gpu, sizes)
    g = _r50_train_state(graph_gpu)
    got = _train_run(g, batches)
    assert got[2] == [0, 1, 0, 1, 1, 1]
    e = _r50_train_state(graph_gpu)
    want = _train_run(e, batches, monkeypatch, graphed=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_train_states_equal(g, e)


def test_graphed_heatmap_step_load_state_dict_mid_run(graph_gpu,
                                                      monkeypatch):
    """A state saved after step 2 and loaded before step 5 (of 7): the
    load drops the graph, step 5 runs eagerly, step 6 captures anew, and
    the run equals the eager one doing the same, bit for bit; the saved
    state is in the eager format (lr floats, step counts on the host)."""
    import io

    batches = _r50_batches(graph_gpu, [8] * 7)

    def saver():
        saved = {}

        def between(k, state):
            if k == 2:
                buf = io.BytesIO()
                torch.save(state.state_dict(), buf)
                saved["sd"] = buf.getvalue()
            if k == 4:
                state.load_state_dict(torch.load(io.BytesIO(saved["sd"]),
                                                 weights_only=False))
        return between, saved

    between, saved = saver()
    g = _r50_train_state(graph_gpu)
    got = _train_run(g, batches, between=between)
    assert got[2] == [0, 1, 1, 1, 0, 1, 1]
    sd = torch.load(io.BytesIO(saved["sd"]), weights_only=False)
    inner = sd["optimizer"]["inner"]
    assert all(type(grp["lr"]) is float and not grp["capturable"]
               for grp in inner["param_groups"])
    assert all(st["step"].device.type == "cpu"
               for st in inner["state"].values())
    between, _ = saver()
    e = _r50_train_state(graph_gpu)
    want = _train_run(e, batches, monkeypatch, graphed=False,
                      between=between)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_train_states_equal(g, e)


def test_planted_noop_update_is_captured_too(graph_gpu):
    """A no-op planted on the inner optimizer's step before the first
    step (the benchmark's `unchanged` fault) is captured with the rest:
    after an eager step, a capture and a replay every parameter is
    bit-unchanged, while the BatchNorm statistics moved."""
    batches = _r50_batches(graph_gpu, [8] * 3)
    s = _r50_train_state(graph_gpu)
    s.optimizer.inner.step = lambda *a, **k: None
    p0 = [p.detach().clone() for p in s.model.parameters()]
    b0 = s.model.backbone.bn1.running_mean.clone()
    assert _train_run(s, batches)[2] == [0, 1, 1]
    assert all(torch.equal(p, q) for p, q in zip(s.model.parameters(), p0))
    assert not torch.equal(s.model.backbone.bn1.running_mean, b0)
    assert s.step == 3


def test_graph_replay_counter_and_launches(graph_gpu, monkeypatch):
    """The `train.graph_replay` counter is 1 on the roots of replayed steps
    (the capture's call replays too) and absent on eager ones; a blocked
    state never replays; K7 runs once a step on the device, replays
    included (the profiler's kernel records, which CUPTI writes for each
    kernel of a graph), while its wrapper's counter counts the launches
    from the host alone: the eager step and the capture; a replayed
    step's spans are train.input and train.replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpupose_torch.engine.train_state as ts
    from tpupose_torch.ops.cuda_warp import affine_warp
    from tpupose_torch.utils import trace

    batches = _r50_batches(graph_gpu, [8] * 4)
    s = _r50_train_state(graph_gpu)
    n0 = affine_warp.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert _train_run(s, batches)[2] == [0, 1, 1, 1]
    assert affine_warp.launches - n0 == 2
    assert sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "warp_kernel" in e.name) == 4
    last = max(r[1] for r in trace._records)
    assert [r[0] for r in trace._records if r[1] == last] == [
        "train.input", "train.replay", "train.step"]
    monkeypatch.setattr(ts, "graph_blocker", lambda st: "blocked")
    s = _r50_train_state(graph_gpu)
    assert _train_run(s, batches)[2] == [0, 0, 0, 0]


@pytest.mark.parametrize("change", ["remat", "bn_momentum"])
def test_graphed_heatmap_step_follows_a_route_change(graph_gpu, monkeypatch,
                                                     change):
    """A plain setting of the model changed after the capture (the
    backbone's remat, which launches the forward twice; a BatchNorm's
    momentum, a float the capture froze) is caught: the next step runs
    eagerly and the one after captures anew, and the run equals the
    eager one making the same change, bit for bit."""
    batches = _r50_batches(graph_gpu, [8] * 6)

    def between(k, state):
        if k == 3:
            if change == "remat":
                state.model.backbone.remat = True
            else:
                state.model.backbone.bn1.momentum = 0.5

    g = _r50_train_state(graph_gpu)
    got = _train_run(g, batches, between=between)
    assert got[2] == [0, 1, 1, 0, 1, 1]
    e = _r50_train_state(graph_gpu)
    want = _train_run(e, batches, monkeypatch, graphed=False,
                      between=between)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_train_states_equal(g, e)
