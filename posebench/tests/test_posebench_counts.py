"""The shape-based counts against values worked by hand."""

from posebench.counts import kernels, models, shapes
from posebench.peaks import least_seconds


def test_conv_deconv_attention_ops_by_hand():
    # 3x3 convolution, 3 -> 4 channels, 2 crops of 5 x 6 outputs:
    # 2 crops * 30 pixels * 4 outputs * 27 taps = 6480 multiply-adds
    assert shapes.conv_ops(2, 3, 4, 3, 5, 6) == 2 * 6480
    # 4x4 transposed convolution 8 -> 4 over a 2 x 3 input:
    # 6 input pixels * 8 * 4 * 16 = 3072 multiply-adds
    assert shapes.deconv_ops(1, 8, 4, 4, 2, 3) == 2 * 3072
    # attention, 2 sequences, 3 heads, 5 tokens, head dim 4:
    # QK^T and PV each 2 * 3 * 5 * 5 * 4 = 600 multiply-adds
    assert shapes.attention_ops(2, 3, 5, 5, 4) == 2 * 2 * 600
    assert shapes.linear_ops(7, 3, 5) == 2 * 105


def test_kernel_bytes_by_hand():
    # K7: 1 crop 2 x 3 x 3: 18 uint8 in, 18 float32 out, one 2x3 matrix
    assert kernels.warp(1, 2, 3, 3)[1] == 18 + 72 + 24
    # K8: q, k, v, o of (1, 2, 1, 4) bf16 = 4 * 8 * 2 bytes; lse 2 floats
    ops, nbytes = kernels.attention_forward(1, 1, 2, 4, lse=False)
    assert (ops, nbytes) == (2 * 2 * 1 * 2 * 2 * 4, 64)
    assert kernels.attention_forward(1, 1, 2, 4, lse=True)[1] == 64 + 8
    # K8b: four products; q, k, v, o, do in and dq, dk, dv out, lse in
    ops, nbytes = kernels.attention_backward(1, 1, 2, 4)
    # (each product 2 x 2 x 4 = 16 multiply-adds)
    assert ops == 4 * 2 * 16 and nbytes == 8 * 16 + 8


R50 = dict(family="resnet_pose", image_size=[256, 192], stage_blocks=[3, 4,
           6, 3], stage_widths=[64, 128, 256, 512], expansion=4,
           deconv_channels=[256, 256, 256], deconv_kernel=4,
           num_keypoints=17)
VIT = dict(family="vitpose", image_size=[256, 192], patch_size=16, dim=384,
           heads=6, depth=12, mlp_hidden=1536, storage_tokens=4,
           deconv_channels=[256, 256], deconv_kernel=4, num_keypoints=17)


def test_layer1_by_hand():
    # per 64 x 48 pixel: block 0 = 64*64 + 9*64*64 + 64*256 + 64*256,
    # blocks 1-2 = 256*64 + 9*64*64 + 64*256 multiply-adds
    per_px = (4096 + 36864 + 16384 + 16384) + 2 * (16384 + 36864 + 16384)
    ops, nbytes = kernels.layer1(1, R50)
    assert ops == 2 * per_px * 3072
    weights = 2 * per_px
    biases = 4 * (64 + 64 + 256 + 256 + 2 * (64 + 64 + 256))
    assert nbytes == 2 * 3072 * (64 + 256) + weights + biases
    # bound by operations at B = 128 (0.169 ms on the bf16 peak)
    ops, nbytes = kernels.layer1(128, R50)
    assert abs(least_seconds(ops, nbytes) - ops / 989e12) < 1e-12


def test_model_flops():
    # ViT-S/16 at 256 x 192: 197 tokens; a block's linears 197 * 384 *
    # (1152 + 384 + 1536 + 1536) and attention 2 * 6 * 197^2 * 64
    # multiply-adds; the patch embedding 192 * 384 * 768; the decoder's
    # deconvolutions over 16 x 12 and 32 x 24 inputs, the 1x1 over 64 x 48
    block = 197 * 384 * (1152 + 384 + 1536 + 1536) + 2 * 6 * 197 ** 2 * 64
    dec = 192 * 384 * 256 * 16 + 768 * 256 * 256 * 16 + 3072 * 256 * 17
    want = 2 * (192 * 384 * 768 + 12 * block + dec)
    assert models.forward_flops(VIT) == want
    # SimpleBaseline-R50: about 10.4-10.9 GFLOP a crop
    assert 10.4e9 < models.forward_flops(R50) < 10.9e9
