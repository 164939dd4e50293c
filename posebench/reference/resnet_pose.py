"""SimpleBaseline (Xiao et al. 2018, arXiv:1804.06208) in plain float32
torch: a ResNet (He et al. 2016) without its classifier, N deconvolutions
4x4/2 with BatchNorm and ReLU, and a 1x1 convolution to K heatmaps.

The tensors are named as torchvision names a ResNet and as the
SimpleBaseline head is usually written (`backbone.layer1.0.conv1.weight`,
`head.deconv_layers.0.weight`, `head.final_layer.bias`), so one dict of
weights made by the benchmark loads into the program and feeds this
function alike. Padding: 1 on every 3x3 (stride 2 included), 0 on the 1x1
shortcut, stem 7x7/2 pad 3, max-pool 3x3/2 pad 1; BatchNorm eps 1e-5;
deconvolution padding 1 (output twice the input). The final 1x1 has a
bias; no other convolution has one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posebench.reference.common import quant_or_id

BN_EPS = 1e-5


def _bn_specs(prefix: str, c: int, weight: str = "bn_weight"):
    return [(f"{prefix}.weight", (c,), weight),
            (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "bn_mean"),
            (f"{prefix}.running_var", (c,), "bn_var"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def param_specs(w: dict):
    """[(name, shape, kind)] of every tensor of the model of widths `w`
    (the configuration file's "widths")."""
    out = [("backbone.conv1.weight", (64, 3, 7, 7), "conv_relu")]
    out += _bn_specs("backbone.bn1", 64)
    cin = 64
    exp = w["expansion"]
    for s, (n, planes) in enumerate(zip(w["stage_blocks"], w["stage_widths"])):
        for j in range(n):
            p = f"backbone.layer{s + 1}.{j}"
            cout = planes * exp
            out += [(f"{p}.conv1.weight", (planes, cin, 1, 1), "conv_relu")]
            out += _bn_specs(f"{p}.bn1", planes)
            out += [(f"{p}.conv2.weight", (planes, planes, 3, 3), "conv_relu")]
            out += _bn_specs(f"{p}.bn2", planes)
            out += [(f"{p}.conv3.weight", (cout, planes, 1, 1), "conv_relu")]
            out += _bn_specs(f"{p}.bn3", cout, "bn_weight_residual")
            if j == 0:
                out += [(f"{p}.downsample.0.weight", (cout, cin, 1, 1),
                         "conv_relu")]
                out += _bn_specs(f"{p}.downsample.1", cout)
            cin = cout
    k = w["deconv_kernel"]
    for i, c in enumerate(w["deconv_channels"]):
        out += [(f"head.deconv_layers.{3 * i}.weight", (cin, c, k, k),
                 "deconv_relu")]
        out += _bn_specs(f"head.deconv_layers.{3 * i + 1}", c)
        cin = c
    out += [("head.final_layer.weight", (w["num_keypoints"], cin, 1, 1),
             "conv_out"),
            ("head.final_layer.bias", (w["num_keypoints"],), "zero")]
    return out


def _bn(x, P, prefix, train):
    return F.batch_norm(x, P[f"{prefix}.running_mean"],
                        P[f"{prefix}.running_var"], P[f"{prefix}.weight"],
                        P[f"{prefix}.bias"], training=train, momentum=0.0,
                        eps=BN_EPS)


def forward(P: dict, x: torch.Tensor, w: dict, train: bool = False,
            quant: bool = False) -> torch.Tensor:
    """Normalised NCHW float32 crops -> heatmaps (B, K, H/4, W/4).

    train: BatchNorm on the batch's statistics (the biased variance), the
    running statistics untouched; else on the running statistics.
    quant: every convolution's input and weight rounded to fp8 first (the
    control)."""
    q = quant_or_id(quant)

    def conv(x, name, stride=1, pad=0):
        return F.conv2d(q(x), q(P[name]), stride=stride, padding=pad)

    x = conv(x, "backbone.conv1.weight", 2, 3)
    x = F.relu(_bn(x, P, "backbone.bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    for s, n in enumerate(w["stage_blocks"]):
        for j in range(n):
            p = f"backbone.layer{s + 1}.{j}"
            stride = 2 if (s > 0 and j == 0) else 1
            y = F.relu(_bn(conv(x, f"{p}.conv1.weight"), P, f"{p}.bn1",
                           train))
            y = F.relu(_bn(conv(y, f"{p}.conv2.weight", stride, 1), P,
                           f"{p}.bn2", train))
            y = _bn(conv(y, f"{p}.conv3.weight"), P, f"{p}.bn3", train)
            if j == 0:
                r = _bn(conv(x, f"{p}.downsample.0.weight", stride), P,
                        f"{p}.downsample.1", train)
            else:
                r = x
            x = F.relu(y + r)
    for i in range(len(w["deconv_channels"])):
        x = F.conv_transpose2d(q(x), q(P[f"head.deconv_layers.{3 * i}.weight"]),
                               stride=2, padding=1)
        x = F.relu(_bn(x, P, f"head.deconv_layers.{3 * i + 1}", train))
    return F.conv2d(q(x), q(P["head.final_layer.weight"]),
                    P["head.final_layer.bias"])
