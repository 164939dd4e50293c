"""Forward FLOPs of one crop of a ViTPose model on a plain ViT with
prefix tokens (posebench/configs widths of "family": "vitpose")."""

from __future__ import annotations

from posebench.counts.shapes import (attention_ops, conv_ops, decoder_flops,
                                     linear_ops)


def flops(w: dict) -> int:
    H, W = w["image_size"]
    p, d, hid = w["patch_size"], w["dim"], w["mlp_hidden"]
    ph, pw = H // p, W // p
    T = ph * pw + 1 + w["storage_tokens"]
    total = conv_ops(1, 3, d, p, ph, pw)
    block = (linear_ops(T, d, 3 * d) + linear_ops(T, d, d)
             + linear_ops(T, d, hid) + linear_ops(T, hid, d)
             + attention_ops(1, w["heads"], T, T, d // w["heads"]))
    return total + w["depth"] * block + decoder_flops(w, d, ph, pw)
