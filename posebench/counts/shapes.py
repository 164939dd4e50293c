"""Operations of single layers, from their shapes alone: 2 per
multiply-add."""

from __future__ import annotations


def conv_ops(b, cin, cout, k, oh, ow):
    return 2 * b * oh * ow * cout * cin * k * k


def deconv_ops(b, cin, cout, k, ih, iw):
    """A transposed convolution, counted over its input pixels: every
    input pixel meets every weight once."""
    return 2 * b * ih * iw * cin * cout * k * k


def linear_ops(rows, fin, fout):
    return 2 * rows * fin * fout


def attention_ops(b, heads, lq, lk, d):
    """Attention's two matrix products, QK^T and PV."""
    return 2 * 2 * b * heads * lq * lk * d


def decoder_flops(w, cin, h, wd) -> int:
    """The heatmap decoder: deconvolutions 4x4/2 (`deconv_channels`), then
    a 1x1 to `num_keypoints` maps, from a (cin, h, wd) feature map."""
    total = 0
    k = w["deconv_kernel"]
    for c in w["deconv_channels"]:
        total += deconv_ops(1, cin, c, k, h, wd)
        h, wd, cin = 2 * h, 2 * wd, c
    return total + conv_ops(1, cin, w["num_keypoints"], 1, h, wd)
