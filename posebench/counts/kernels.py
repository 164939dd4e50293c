"""Operations and bytes of the work each hand-written kernel does on a
cell's path, from the shapes of the layer it implements: inputs, weights
and outputs counted once (bf16 activations and weights unless stated),
whatever a design re-reads or writes in between."""

from __future__ import annotations

from posebench.counts.shapes import attention_ops, conv_ops


def layer1(b: int, w: dict):
    """K2: ResNet layer1 (its blocks at 1/4 of the crop, 64 -> 256
    channels, the shortcut convolution of block 0 included) on b crops.
    Bytes: the (b, 64, h, w) input, the (b, 256, h, w) output and the
    convolution weights in bf16, the folded biases in float32."""
    H, W = w["image_size"]
    h, wd = H // 4, W // 4
    planes = w["stage_widths"][0]
    cout = planes * w["expansion"]
    ops, wbytes, bias = 0, 0, 0
    cin = 64
    for j in range(w["stage_blocks"][0]):
        convs = [(cin, planes, 1), (planes, planes, 3), (planes, cout, 1)]
        if j == 0:
            convs.append((cin, cout, 1))
        for ci, co, k in convs:
            ops += conv_ops(b, ci, co, k, h, wd)
            wbytes += 2 * ci * co * k * k
            bias += 4 * co
        cin = cout
    act = 2 * b * h * wd * (64 + cout)
    return ops, act + wbytes + bias


def warp(b: int, h: int, w: int, c: int):
    """K7: the affine warp of b uint8 (h, w, c) crops to float32 crops of
    the same size. About 10 operations an output value (two products per
    tap weight and the blend), bound by its bytes: the uint8 source, the
    float32 output, the (b, 2, 3) float32 matrices."""
    n = b * h * w * c
    return 10 * n, n + 4 * n + 24 * b


def attention_forward(b: int, heads: int, L: int, d: int, lse: bool):
    """K8: softmax(q k^T / sqrt(d)) v over (b, L, heads, d) bf16; q, k, v
    read and o written once; with `lse` the float32 log-sum-exp rows the
    backward takes are written too."""
    nbytes = 4 * 2 * b * L * heads * d + (4 * b * heads * L if lse else 0)
    return attention_ops(b, heads, L, L, d), nbytes


def attention_backward(b: int, heads: int, L: int, d: int):
    """K8b: dq, dk, dv from q, k, v, o, do (bf16) and the float32
    log-sum-exp rows. The products the gradient needs: dV = P^T dO,
    dP = dO V^T, dQ = dS K, dK = dS^T Q (the recomputation of P is a
    design's choice and is not counted)."""
    ops = 2 * attention_ops(b, heads, L, L, d)
    nbytes = 8 * 2 * b * L * heads * d + 4 * b * heads * L
    return ops, nbytes
