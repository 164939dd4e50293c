"""Flax -> PyTorch weight transfer (the port's own inverse of
tpupose/utils/convert.py).

`from_flax_simple_baseline` maps a flax SimpleBaseline variable tree
(numpy arrays) onto the state dict of
`tpupose_torch.models.simple_baseline.SimpleBaseline`,
`from_flax_hrnet` a flax HRNetPose tree onto
`tpupose_torch.models.backbones.hrnet.HRNetPose`, and
`from_flax_vitpose` a flax ViTPose tree onto
`tpupose_torch.models.vitpose.ViTPose`, and `from_flax_dinov3_pose` a
flax DINOv3Pose tree (ConvNeXt or ViT backbone) onto
`tpupose_torch.models.dinov3_pose.DINOv3Pose`; `from_flax_deeppose`,
`from_flax_simcc` and `from_flax_bottom_up` map DeepPose (RLE head and
flow included), SimCCPose and BottomUpPose trees. The first two serve two
uses: giving the port the JAX package's weights (serving parity, and
the same start for a training comparison), and mapping the params and
batch stats (or the EMA params) that JAX reached after some train steps
onto the port's names, to compare them with the port's own:

  - conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in);
  - flax ConvTranspose kernels (kh, kw, I, O) -> torch (I, O, kh, kw),
    rotated 180 degrees in space (flax runs the transposed conv as a
    fractionally strided correlation with the kernel as it is; torch's is
    the gradient of a correlation);
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    LayerNorm scale/bias -> weight/bias.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpupose_torch.models.backbones.resnet import _SPECS


def conv_weight(k) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))))


def deconv_weight(k) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d
    weight (I, O, kh, kw), spatially rotated 180 degrees."""
    k = np.asarray(k, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k,
                                                              (2, 3, 0, 1))))


def _bn(sd: dict, prefix: str, p: Mapping, s: Mapping):
    sd[f"{prefix}.weight"] = torch.from_numpy(np.asarray(p["scale"],
                                                         np.float32))
    sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["bias"], np.float32))
    sd[f"{prefix}.running_mean"] = torch.from_numpy(np.asarray(s["mean"],
                                                               np.float32))
    sd[f"{prefix}.running_var"] = torch.from_numpy(np.asarray(s["var"],
                                                              np.float32))
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _stage_sizes(params: Mapping):
    """The flax tree names blocks Bottleneck_i / BasicBlock_i; the block
    type and count identify the ResNet depth."""
    for kind in ("Bottleneck", "BasicBlock"):
        n = sum(1 for k in params if k.startswith(kind + "_"))
        if n:
            for block, sizes in _SPECS.values():
                if block.__name__ == kind and sum(sizes) == n:
                    return kind, sizes
    raise ValueError("unrecognised ResNet block layout in the flax tree")


def _conv(sd: dict, prefix: str, p: Mapping, paths, path: str):
    """A bias-free flax Conv -> `{prefix}.weight`; records the flax module
    path of the port module `prefix` in `paths` (when given)."""
    sd[f"{prefix}.weight"] = conv_weight(p["kernel"])
    if paths is not None:
        paths[prefix] = path


def _block(sd: dict, t: str, bp: Mapping, bs: Mapping, paths, path: str):
    """A flax BasicBlock / Bottleneck (Conv_i + BatchNorm_i, the
    projection last) -> the port block `t` (conv{i+1}/bn{i+1},
    downsample.0/.1). The block type is told by its conv count."""
    n_convs = 3 if bp["Conv_0"]["kernel"].shape[0] == 1 else 2
    for c in range(n_convs):
        _conv(sd, f"{t}.conv{c + 1}", bp[f"Conv_{c}"], paths,
              f"{path}/Conv_{c}")
        _bn(sd, f"{t}.bn{c + 1}", bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"])
    if f"Conv_{n_convs}" in bp:
        _conv(sd, f"{t}.downsample.0", bp[f"Conv_{n_convs}"], paths,
              f"{path}/Conv_{n_convs}")
        _bn(sd, f"{t}.downsample.1", bp[f"BatchNorm_{n_convs}"],
            bs[f"BatchNorm_{n_convs}"])


def _resnet(sd: dict, rp: Mapping, rs: Mapping, paths,
            path: str = "ResNet_0"):
    """A flax ResNet subtree -> the port's ResNet under `backbone.`."""
    _conv(sd, "backbone.conv1", rp["Conv_0"], paths, f"{path}/Conv_0")
    _bn(sd, "backbone.bn1", rp["BatchNorm_0"], rs["BatchNorm_0"])
    kind, sizes = _stage_sizes(rp)
    bidx = 0
    for li, size in enumerate(sizes):
        for j in range(size):
            _block(sd, f"backbone.layer{li + 1}.{j}", rp[f"{kind}_{bidx}"],
                   rs[f"{kind}_{bidx}"], paths, f"{path}/{kind}_{bidx}")
            bidx += 1


def from_flax_simple_baseline(variables: Mapping,
                              paths: dict | None = None) -> dict:
    """flax SimpleBaseline {params, batch_stats} (numpy or jax arrays) ->
    state dict for tpupose_torch's SimpleBaseline (float32 CPU tensors;
    `load_state_dict` casts them to the model's dtype and device).
    `paths`, when given, is filled with {port conv / deconv module name:
    flax module path} (the keys of tpupose's PTQ scales)."""
    P, S = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _resnet(sd, P["ResNet_0"], S["ResNet_0"], paths)
    _heatmap_head(sd, P["HeatmapHead_0"], S["HeatmapHead_0"], paths,
                  "HeatmapHead_0")
    return sd


def _convbn(sd: dict, prefix: str, p: Mapping, s: Mapping, paths,
            path: str):
    """flax `_ConvBN` {Conv_0, BatchNorm_0} -> the port's `_ConvBN`."""
    _conv(sd, f"{prefix}.conv", p["Conv_0"], paths, f"{path}/Conv_0")
    _bn(sd, f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])


def from_flax_hrnet(variables: Mapping, paths: dict | None = None) -> dict:
    """flax HRNetPose {params, batch_stats} -> state dict for
    tpupose_torch's HRNetPose (float32 CPU tensors). Follows flax's
    auto-numbering, the order in which the module is called (as
    tpupose's `fold_hrnet_pose` walks it): `HRNet_0/_ConvBN_{0,1}` the
    stem, `Bottleneck_{0..3}` (Bottleneck_0's projection its
    Conv_3/BatchNorm_3), the transitions `_ConvBN_{2,3}`, `_ConvBN_4`,
    `_ConvBN_5`, `_Stage_k/_Branch_{m*n+i}/BasicBlock_b`,
    `_Stage_k/_FuseLayer_m/_ConvBN_c` numbered in the (i, j, step) loop
    order, and the head `Conv_0` beside `HRNet_0`. The widths and module
    counts are read off the tree. `paths` as in
    from_flax_simple_baseline."""
    P, S = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _hrnet(sd, P["HRNet_0"], S["HRNet_0"], paths)
    sd["final_layer.weight"] = conv_weight(P["Conv_0"]["kernel"])
    sd["final_layer.bias"] = _t(P["Conv_0"]["bias"])
    if paths is not None:
        paths["final_layer"] = "Conv_0"
    return sd


def _hrnet(sd: dict, hp: Mapping, hs: Mapping, paths):
    """A flax HRNet subtree (`HRNet_0`) -> the port's HRNet under
    `backbone.` (the numbering of from_flax_hrnet)."""

    def cb(prefix, idx, scope_p=hp, scope_s=hs, path="HRNet_0"):
        _convbn(sd, prefix, scope_p[f"_ConvBN_{idx}"],
                scope_s[f"_ConvBN_{idx}"], paths, f"{path}/_ConvBN_{idx}")

    cb("backbone.stem.0", 0)
    cb("backbone.stem.1", 1)
    for n in range(4):
        _block(sd, f"backbone.layer1.{n}", hp[f"Bottleneck_{n}"],
               hs[f"Bottleneck_{n}"], paths, f"HRNet_0/Bottleneck_{n}")
    cb("backbone.transition1.0", 2)
    cb("backbone.transition1.1", 3)
    cb("backbone.transition2", 4)
    cb("backbone.transition3", 5)
    for k in range(3):
        sp, ss = hp[f"_Stage_{k}"], hs[f"_Stage_{k}"]
        n = k + 2
        base, path = f"backbone.stage{k + 2}", f"HRNet_0/_Stage_{k}"
        m = 0
        while f"_FuseLayer_{m}" in sp:
            for i in range(n):
                bp = sp[f"_Branch_{m * n + i}"]
                bs = ss[f"_Branch_{m * n + i}"]
                b = 0
                while f"BasicBlock_{b}" in bp:
                    _block(sd, f"{base}.branches.{m}.{i}.blocks.{b}",
                           bp[f"BasicBlock_{b}"], bs[f"BasicBlock_{b}"],
                           paths, f"{path}/_Branch_{m * n + i}/BasicBlock_{b}")
                    b += 1
            fp, fs = sp[f"_FuseLayer_{m}"], ss[f"_FuseLayer_{m}"]
            fpath, c = f"{path}/_FuseLayer_{m}", 0
            for i in range(n):
                for j in range(n):
                    t = f"{base}.fuse.{m}.paths.{i}_{j}"
                    if j > i:
                        cb(t, c, fp, fs, fpath)
                        c += 1
                    elif j < i:
                        for step in range(i - j):
                            cb(f"{t}.{step}", c, fp, fs, fpath)
                            c += 1
            m += 1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(sd: dict, prefix: str, p: Mapping):
    """flax Dense {kernel (in, out), bias} -> torch Linear (out, in)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd: dict, prefix: str, p: Mapping):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _heatmap_head(sd: dict, hp: Mapping, hs: Mapping, paths=None,
                  path: str = ""):
    """ConvTranspose_i / BatchNorm_i / Conv_0 of a flax deconv head ->
    the port's HeatmapHead under `head.`."""
    pre = f"{path}/" if path else ""
    i = 0
    while f"ConvTranspose_{i}" in hp:
        sd[f"head.deconv_layers.{3 * i}.weight"] = deconv_weight(
            hp[f"ConvTranspose_{i}"]["kernel"])
        _bn(sd, f"head.deconv_layers.{3 * i + 1}", hp[f"BatchNorm_{i}"],
            hs[f"BatchNorm_{i}"])
        if paths is not None:
            paths[f"head.deconv_layers.{3 * i}"] = f"{pre}ConvTranspose_{i}"
        i += 1
    sd["head.final_layer.weight"] = conv_weight(hp["Conv_0"]["kernel"])
    sd["head.final_layer.bias"] = _t(hp["Conv_0"]["bias"])
    if paths is not None:
        paths["head.final_layer"] = f"{pre}Conv_0"


def _with_bias(sd: dict, prefix: str, p: Mapping, paths, path: str,
               dense: bool = False):
    """A flax Conv (or Dense) with its bias -> `{prefix}.weight/.bias`;
    records the flax module path in `paths` (when given)."""
    if dense:
        _dense(sd, prefix, p)
    else:
        sd[f"{prefix}.weight"] = conv_weight(p["kernel"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
    if paths is not None:
        paths[prefix] = path


def _dino_vit(sd: dict, vp: Mapping, paths=None, path: str = "DinoViT_0"):
    """A flax DinoViT subtree -> the port's DinoViT under `backbone.`."""
    _with_bias(sd, "backbone.patch_embed.proj", vp["patch_embed"], paths,
               f"{path}/patch_embed")
    sd["backbone.cls_token"] = _t(vp["cls_token"])
    sd["backbone.storage_tokens"] = _t(vp["storage_tokens"])
    i = 0
    while f"ViTBlock_{i}" in vp:
        bp, t = vp[f"ViTBlock_{i}"], f"backbone.blocks.{i}"
        bpath = f"{path}/ViTBlock_{i}"
        _ln(sd, f"{t}.norm1", bp["LayerNorm_0"])
        for name, key in (("qkv", "qkv"), ("proj", "proj")):
            _with_bias(sd, f"{t}.attn.{name}", bp["RopeAttention_0"][key],
                       paths, f"{bpath}/RopeAttention_0/{key}", dense=True)
        sd[f"{t}.ls1.gamma"] = _t(bp["ls1"])
        _ln(sd, f"{t}.norm2", bp["LayerNorm_1"])
        _with_bias(sd, f"{t}.mlp.fc1", bp["Dense_0"], paths,
                   f"{bpath}/Dense_0", dense=True)
        _with_bias(sd, f"{t}.mlp.fc2", bp["Dense_1"], paths,
                   f"{bpath}/Dense_1", dense=True)
        sd[f"{t}.ls2.gamma"] = _t(bp["ls2"])
        i += 1
    _ln(sd, "backbone.norm", vp["norm"])


def from_flax_vitpose(variables: Mapping) -> dict:
    """flax ViTPose {params[, batch_stats]} (numpy or jax arrays) -> state
    dict for tpupose_torch's ViTPose (float32 CPU tensors). The decoder
    is told by the tree: ConvTranspose_i (classic) or Conv_0/Conv_1
    (simple)."""
    P = variables["params"]
    S = variables.get("batch_stats", {})
    sd: dict = {}
    _dino_vit(sd, P["DinoViT_0"])
    if "ConvTranspose_0" in P:
        _heatmap_head(sd, P, S)
    else:
        for name, key in (("head.conv", "Conv_0"),
                          ("head.final_layer", "Conv_1")):
            sd[f"{name}.weight"] = conv_weight(P[key]["kernel"])
            sd[f"{name}.bias"] = _t(P[key]["bias"])
    return sd


def _convnext(sd: dict, cp: Mapping, paths, path: str = "ConvNeXt_0"):
    """A flax ConvNeXt subtree -> the port's ConvNeXt under `backbone.`:
    Conv_0 + LayerNorm_0 the stem, LayerNorm_i + Conv_i the downsample
    before stage i, ConvNeXtBlock_k numbered across stages (a block's
    stage told by its width)."""
    dims = []
    i = 0
    while f"Conv_{i}" in cp:
        dl = f"backbone.downsample_layers.{i}"
        conv, norm = (f"{dl}.0", f"{dl}.1") if i == 0 else (f"{dl}.1",
                                                            f"{dl}.0")
        _with_bias(sd, conv, cp[f"Conv_{i}"], paths, f"{path}/Conv_{i}")
        _ln(sd, norm, cp[f"LayerNorm_{i}"])
        dims.append(int(np.shape(cp[f"Conv_{i}"]["kernel"])[-1]))
        i += 1
    counts = [0] * len(dims)
    k = 0
    while f"ConvNeXtBlock_{k}" in cp:
        bp, bpath = cp[f"ConvNeXtBlock_{k}"], f"{path}/ConvNeXtBlock_{k}"
        stage = dims.index(int(np.shape(bp["Conv_0"]["kernel"])[-1]))
        t = f"backbone.stages.{stage}.{counts[stage]}"
        counts[stage] += 1
        _with_bias(sd, f"{t}.dwconv", bp["Conv_0"], paths, f"{bpath}/Conv_0")
        _ln(sd, f"{t}.norm", bp["LayerNorm_0"])
        _with_bias(sd, f"{t}.pwconv1", bp["Dense_0"], paths,
                   f"{bpath}/Dense_0", dense=True)
        _with_bias(sd, f"{t}.pwconv2", bp["Dense_1"], paths,
                   f"{bpath}/Dense_1", dense=True)
        if "gamma" in bp:
            sd[f"{t}.gamma"] = _t(bp["gamma"])
        if "GRN_0" in bp:
            sd[f"{t}.grn.gamma"] = _t(bp["GRN_0"]["gamma"])
            sd[f"{t}.grn.beta"] = _t(bp["GRN_0"]["beta"])
        k += 1


def from_flax_dinov3_pose(variables: Mapping,
                          paths: dict | None = None) -> dict:
    """flax DINOv3Pose {params, batch_stats} -> state dict for
    tpupose_torch's DINOv3Pose (float32 CPU tensors), either backbone
    (ConvNeXt_0 or DinoViT_0), reg_max 0 or > 0 (the box branch's
    ConvBlocks and Conv_l directly in PoseHead_0). Follows flax's
    numbering in call order: FeatureAdaptor_0/ConvBlock_{2l, 2l+1},
    SPPF_0/ConvBlock_{0,1}, PAN_0 ConvBlock_0 / BottleneckCSP_0 (the
    top-down P4), ConvBlock_1 / BottleneckCSP_1 (P3), ConvBlock_2 /
    BottleneckCSP_2 (bottom-up P4), ConvBlock_3 / BottleneckCSP_3 (P5),
    and per level _ClsBranch_l / _KptBranch_l. `paths` as in
    from_flax_simple_baseline (dense layers included: JAX's PTQ
    quantizes them)."""
    P, S = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def cb(prefix, p, s, path):
        _conv(sd, f"{prefix}.conv", p["Conv_0"], paths, f"{path}/Conv_0")
        _bn(sd, f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    def scope(p, s, path, i, kind="ConvBlock"):
        return p[f"{kind}_{i}"], s[f"{kind}_{i}"], f"{path}/{kind}_{i}"

    def csp(prefix, p, s, path):
        for name, i in (("cv1", 0), ("cv2", 1), ("cv3", 2)):
            cb(f"{prefix}.{name}", *scope(p, s, path, i))
        b = 0
        while f"Bottleneck_{b}" in p:
            bp, bs, bpath = scope(p, s, path, b, "Bottleneck")
            cb(f"{prefix}.m.{b}.cv1", *scope(bp, bs, bpath, 0))
            cb(f"{prefix}.m.{b}.cv2", *scope(bp, bs, bpath, 1))
            b += 1

    if "ConvNeXt_0" in P:
        _convnext(sd, P["ConvNeXt_0"], paths)
    else:
        _dino_vit(sd, P["DinoViT_0"], paths)
    fp, fs = P["FeatureAdaptor_0"], S["FeatureAdaptor_0"]
    for lvl in range(3):
        for j in range(2):
            cb(f"adaptor.levels.{lvl}.{j}",
               *scope(fp, fs, "FeatureAdaptor_0", 2 * lvl + j))
    for name, i in (("cv1", 0), ("cv2", 1)):
        cb(f"sppf.{name}", *scope(P["SPPF_0"], S["SPPF_0"], "SPPF_0", i))
    pp, ps = P["PAN_0"], S["PAN_0"]
    for i, (red, out) in enumerate((("reduce4", "csp4"),
                                    ("reduce3", "csp3"),
                                    ("down4", "out4"), ("down5", "out5"))):
        cb(f"pan.{red}", *scope(pp, ps, "PAN_0", i))
        csp(f"pan.{out}", *scope(pp, ps, "PAN_0", i, "BottleneckCSP"))
    hp, hs, hpath = P["PoseHead_0"], S["PoseHead_0"], "PoseHead_0"
    lvl = 0
    while f"_ClsBranch_{lvl}" in hp:
        if f"Conv_{lvl}" in hp:                     # the DFL box branch
            for j in range(2):
                cb(f"head.box.{lvl}.blocks.{j}",
                   *scope(hp, hs, hpath, 2 * lvl + j))
            _with_bias(sd, f"head.box.{lvl}.out", hp[f"Conv_{lvl}"], paths,
                       f"{hpath}/Conv_{lvl}")
        for kind, n in (("cls", 4), ("kpt", 2)):
            name = f"_{kind.capitalize()}Branch_{lvl}"
            bp, bs, bpath = hp[name], hs[name], f"{hpath}/{name}"
            for j in range(n):
                cb(f"head.{kind}.{lvl}.blocks.{j}", *scope(bp, bs, bpath, j))
            _with_bias(sd, f"head.{kind}.{lvl}.out", bp["Conv_0"], paths,
                       f"{bpath}/Conv_0")
        lvl += 1
    return sd


def _backbone(sd: dict, P: Mapping, S: Mapping, paths):
    """The flax tree's ResNet_0 or HRNet_0 -> the port's `backbone.`."""
    if "HRNet_0" in P:
        _hrnet(sd, P["HRNet_0"], S["HRNet_0"], paths)
    else:
        _resnet(sd, P["ResNet_0"], S["ResNet_0"], paths)


def from_flax_deeppose(variables: Mapping, paths: dict | None = None) -> dict:
    """flax DeepPose {params, batch_stats} -> state dict for
    tpupose_torch's DeepPose (float32 CPU tensors): the ResNet, and
    either RegressionHead_0/Dense_0 (`head.fc`) or, for rle=True, the
    `rle_head` Dense and the flow's flow/_Coupling_i/Dense_j
    (`flow.couplings.i.layers.j`). `paths` as in
    from_flax_simple_baseline (dense layers included)."""
    P, S = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _backbone(sd, P, S, paths)
    if "rle_head" in P:
        _with_bias(sd, "rle_head", P["rle_head"], paths, "rle_head",
                   dense=True)
        fp, i = P["flow"], 0
        while f"_Coupling_{i}" in fp:
            for j in range(4):
                _with_bias(sd, f"flow.couplings.{i}.layers.{j}",
                           fp[f"_Coupling_{i}"][f"Dense_{j}"], paths,
                           f"flow/_Coupling_{i}/Dense_{j}", dense=True)
            i += 1
    else:
        _with_bias(sd, "head.fc", P["RegressionHead_0"]["Dense_0"], paths,
                   "RegressionHead_0/Dense_0", dense=True)
    return sd


def from_flax_simcc(variables: Mapping, paths: dict | None = None) -> dict:
    """flax SimCCPose {params, batch_stats} (ResNet_0 or HRNet_0 backbone)
    -> state dict for tpupose_torch's SimCCPose: SimCCHead_0's kpt_conv,
    and mlp_x / mlp_y with their (h*w, bins) kernels transposed. `paths`
    as in from_flax_simple_baseline (dense layers included)."""
    P, S = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _backbone(sd, P, S, paths)
    hp = P["SimCCHead_0"]
    _with_bias(sd, "head.kpt_conv", hp["kpt_conv"], paths,
               "SimCCHead_0/kpt_conv")
    for name in ("mlp_x", "mlp_y"):
        _with_bias(sd, f"head.{name}", hp[name], paths,
                   f"SimCCHead_0/{name}", dense=True)
    return sd


def from_flax_bottom_up(variables: Mapping,
                        paths: dict | None = None) -> dict:
    """flax BottomUpPose {params, batch_stats} -> state dict for
    tpupose_torch's BottomUpPose: HRNet_0 + Conv_0 (`final_layer`), or
    ResNet_0 + HeatmapHead_0 (`head`). `paths` as in
    from_flax_simple_baseline."""
    P, S = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _backbone(sd, P, S, paths)
    if "HRNet_0" in P:
        _with_bias(sd, "final_layer", P["Conv_0"], paths, "Conv_0")
    else:
        _heatmap_head(sd, P["HeatmapHead_0"], S["HeatmapHead_0"], paths,
                      "HeatmapHead_0")
    return sd
