"""Forward FLOPs of one crop of a SimpleBaseline-style ResNet pose
model (posebench/configs widths of "family": "resnet_pose")."""

from __future__ import annotations

from posebench.counts.shapes import conv_ops, decoder_flops


def flops(w: dict) -> int:
    H, W = w["image_size"]
    h, wd = H // 2, W // 2                      # stem conv 7x7/2
    total = conv_ops(1, 3, 64, 7, h, wd)
    h, wd = h // 2, wd // 2                     # max-pool 3x3/2
    cin = 64
    for s, (n, planes) in enumerate(zip(w["stage_blocks"],
                                        w["stage_widths"])):
        cout = planes * w["expansion"]
        for j in range(n):
            stride = 2 if (s > 0 and j == 0) else 1
            oh, ow = h // stride, wd // stride
            total += conv_ops(1, cin, planes, 1, h, wd)
            total += conv_ops(1, planes, planes, 3, oh, ow)
            total += conv_ops(1, planes, cout, 1, oh, ow)
            if j == 0:
                total += conv_ops(1, cin, cout, 1, oh, ow)
            h, wd, cin = oh, ow, cout
    return total + decoder_flops(w, cin, h, wd)
