"""tpupose_torch's pretrained-backbone loading and DetectHead against the
JAX package on the CPU.

load_pretrained: seeded torch checkpoints in the released names (a
torchvision ResNet-18 with non-trivial BatchNorm statistics and a `fc`
the backbone does not have, an official ConvNeXt-atto, a DINOv3 ViT in
both naming variants, `ls*.gamma` + `storage_tokens` and `ls*.weight` +
`register_tokens`, with a `mask_token` the backbone does not have) go
through JAX's load_pretrained and the port's converter helpers that
from_flax_simple_baseline / from_flax_dinov3_pose / from_flax_vitpose
are made of, and through the port's load_pretrained into a SimpleBaseline,
a DINOv3Pose and a ViTPose: every backbone tensor, BatchNorm statistics
included, must be equal. Also: a missing file keeps the init (with a
warning), a backbone without a converter raises, and Trainer with
model.pretrained starts from the file, its EMA too. DetectHead: both
variants (plain, and objectness with reg_max 4) on two levels, train-mode
maps (batch statistics) and the eval decode, within 1e-4 of the
reference's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.models import pretrained as jpretrained
from tpupose.models.backbones import vit as jvit
from tpupose.models.yolo_head import DetectHead as JDetectHead
from tpupose_torch.configs import default_config
from tpupose_torch.models import pretrained
from tpupose_torch.models.backbones import vit as tvit
from tpupose_torch.models.dinov3_pose import DINOv3Pose
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.models.vitpose import ViTPose
from tpupose_torch.models.yolo_head import DetectHead
from tpupose_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401

T3 = {"depth": 3, "dim": 64, "heads": 2}


@pytest.fixture(autouse=True)
def t3_size(monkeypatch):
    monkeypatch.setitem(jvit.VIT_SIZES, "t3", T3)
    monkeypatch.setitem(tvit.VIT_SIZES, "t3", T3)


class _SD(dict):
    def __init__(self, seed):
        super().__init__()
        self.rs = np.random.RandomState(seed)

    def t(self, name, *shape, scale=0.1, offset=0.0):
        self[name] = torch.from_numpy(
            (self.rs.randn(*shape) * scale + offset).astype(np.float32))


def resnet18_sd(seed=0) -> dict:
    """torchvision names, BatchNorm statistics and a classifier."""
    sd = _SD(seed)

    def bn(name, c):
        sd.t(f"{name}.weight", c, offset=1.0)
        sd.t(f"{name}.bias", c)
        sd.t(f"{name}.running_mean", c, scale=0.05)
        sd[f"{name}.running_var"] = torch.from_numpy(
            (1 + sd.rs.rand(c) * 0.1).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    sd.t("conv1.weight", 64, 3, 7, 7)
    bn("bn1", 64)
    c_in = 64
    for li, w in enumerate((64, 128, 256, 512)):
        for j in range(2):
            t = f"layer{li + 1}.{j}"
            sd.t(f"{t}.conv1.weight", w, c_in if j == 0 else w, 3, 3)
            bn(f"{t}.bn1", w)
            sd.t(f"{t}.conv2.weight", w, w, 3, 3)
            bn(f"{t}.bn2", w)
            if j == 0 and c_in != w:
                sd.t(f"{t}.downsample.0.weight", w, c_in, 1, 1)
                bn(f"{t}.downsample.1", w)
        c_in = w
    sd.t("fc.weight", 1000, 512)
    sd.t("fc.bias", 1000)
    return dict(sd)


def convnext_sd(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320), seed=1):
    """The official ConvNeXt names (v1 blocks with their layer scale)."""
    sd = _SD(seed)
    sd.t("downsample_layers.0.0.weight", dims[0], 3, 4, 4)
    sd.t("downsample_layers.0.0.bias", dims[0])
    sd.t("downsample_layers.0.1.weight", dims[0], offset=1.0)
    sd.t("downsample_layers.0.1.bias", dims[0])
    for i in range(1, len(depths)):
        sd.t(f"downsample_layers.{i}.0.weight", dims[i - 1], offset=1.0)
        sd.t(f"downsample_layers.{i}.0.bias", dims[i - 1])
        sd.t(f"downsample_layers.{i}.1.weight", dims[i], dims[i - 1], 2, 2)
        sd.t(f"downsample_layers.{i}.1.bias", dims[i])
    for s, (depth, d) in enumerate(zip(depths, dims)):
        for j in range(depth):
            t = f"stages.{s}.{j}"
            sd.t(f"{t}.dwconv.weight", d, 1, 7, 7)
            sd.t(f"{t}.dwconv.bias", d)
            sd.t(f"{t}.norm.weight", d, offset=1.0)
            sd.t(f"{t}.norm.bias", d)
            sd.t(f"{t}.pwconv1.weight", 4 * d, d)
            sd.t(f"{t}.pwconv1.bias", 4 * d)
            sd.t(f"{t}.pwconv2.weight", d, 4 * d)
            sd.t(f"{t}.pwconv2.bias", d)
            sd.t(f"{t}.gamma", d, offset=0.5)
    sd.t("norm.weight", dims[-1])
    return dict(sd)


def vit_sd(variant: str, dim=64, depth=3, seed=2):
    """DINOv3 ViT names; `variant` "gamma" (ls*.gamma, storage_tokens) or
    "weight" (ls*.weight, register_tokens)."""
    sd = _SD(seed)
    sd.t("patch_embed.proj.weight", dim, 3, 16, 16)
    sd.t("patch_embed.proj.bias", dim)
    sd.t("cls_token", 1, 1, dim)
    tokens = "storage_tokens" if variant == "gamma" else "register_tokens"
    sd.t(tokens, 1, 4, dim)
    sd.t("mask_token", 1, dim)
    for i in range(depth):
        t = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd.t(f"{t}.{n}.weight", dim, offset=1.0)
            sd.t(f"{t}.{n}.bias", dim)
        for n, o, k in (("attn.qkv", 3 * dim, dim), ("attn.proj", dim, dim),
                        ("mlp.fc1", 4 * dim, dim), ("mlp.fc2", dim, 4 * dim)):
            sd.t(f"{t}.{n}.weight", o, k)
            sd.t(f"{t}.{n}.bias", o)
        for ls in ("ls1", "ls2"):
            sd.t(f"{t}.{ls}.{variant}", dim, offset=0.3)
    sd.t("norm.weight", dim, offset=1.0)
    sd.t("norm.bias", dim)
    return dict(sd)


def _jax_backbone_sd(pth, backbone, subtree, helper):
    """JAX's load_pretrained into {subtree: {}}, then the port's converter
    helper: the port's `backbone.*` state dict."""
    params, stats = jpretrained.load_pretrained({subtree: {}}, str(pth),
                                                backbone, batch_stats={})
    sd = {}
    if subtree == "ResNet_0":
        helper(sd, params[subtree], stats[subtree], None)
    else:
        helper(sd, params[subtree], None)
    return sd


def _check_loaded(model, want):
    def keep(k):
        return k.startswith("backbone.") \
            and not k.endswith("num_batches_tracked")

    own = {k: v for k, v in model.state_dict().items() if keep(k)}
    want = {k: v for k, v in want.items() if keep(k)}
    assert own.keys() == want.keys()
    for k, v in own.items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("kind", ["resnet18", "convnext_atto", "vit_gamma",
                                  "vit_weight"])
def test_load_pretrained_matches_jax(kind, tmp_path):
    pth = tmp_path / f"{kind}.pth"
    if kind == "resnet18":
        torch.save(resnet18_sd(), pth)
        want = _jax_backbone_sd(pth, "resnet18", "ResNet_0", convert._resnet)
        model = SimpleBaseline("resnet18", 4, (32,), dtype=torch.float32,
                               device="cpu")
        backbone = "resnet18"
    elif kind == "convnext_atto":
        torch.save(convnext_sd(), pth)
        backbone = "dinov3_convnext_atto"
        want = _jax_backbone_sd(pth, backbone, "ConvNeXt_0",
                                convert._convnext)
        model = DINOv3Pose(backbone, 4, 1, (48, 96, 192),
                           dtype=torch.float32, device="cpu")
    else:
        torch.save(vit_sd(kind.split("_")[1]), pth)
        backbone = "vit_t3"
        want = _jax_backbone_sd(pth, backbone, "DinoViT_0",
                                convert._dino_vit)
        model = ViTPose(backbone, 4, "classic", (32, 32),
                        dtype=torch.float32, device="cpu")
    head_before = {k: v.clone() for k, v in model.state_dict().items()
                   if not k.startswith("backbone.")}
    assert pretrained.load_pretrained(model, str(pth), backbone) is True
    _check_loaded(model, want)
    for k, v in model.state_dict().items():
        if k in head_before:
            assert torch.equal(v, head_before[k]), k


def test_load_pretrained_missing_file_keeps_the_init(capsys):
    model = SimpleBaseline("resnet18", 4, (32,), dtype=torch.float32,
                           device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pretrained.load_pretrained(model, "/nonexistent.pth",
                                      "resnet18") is False
    assert "keeping random init" in capsys.readouterr().out
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    out, bs = jpretrained.load_pretrained({"ResNet_0": {}},
                                          "/nonexistent.pth", "resnet18")
    assert out == {"ResNet_0": {}} and bs == {}


def test_load_pretrained_refuses_what_it_cannot_convert(tmp_path):
    pth = tmp_path / "r18.pth"
    torch.save(resnet18_sd(), pth)
    model = SimpleBaseline("resnet18", 4, (32,), dtype=torch.float32,
                           device="cpu")
    with pytest.raises(ValueError, match="no converter"):
        pretrained.load_pretrained(model, str(pth), "hrnet_w32")
    with pytest.raises(ValueError, match="no converter"):
        jpretrained.convert_checkpoint(str(pth), "hrnet_w32")
    part = resnet18_sd()
    del part["layer4.1.conv2.weight"]
    torch.save(part, pth)
    with pytest.raises(KeyError, match="layer4.1.conv2.weight"):
        pretrained.load_pretrained(model, str(pth), "resnet18")


def test_trainer_starts_from_the_pretrained_backbone(tmp_path):
    """Trainer(model.pretrained=...) loads the file into the backbone
    before the first step, BatchNorm statistics included, and copies the
    parameters into the EMA, as JAX's Trainer does."""
    from tpupose_torch.engine.trainer import Trainer

    pth = tmp_path / "r18.pth"
    sd = resnet18_sd()
    torch.save({"state_dict": sd}, pth)
    cfg = default_config()
    cfg.model.backbone = "resnet18"
    cfg.model.num_keypoints = 4
    cfg.model.deconv_channels = (32,)
    cfg.model.heatmap_size = (16, 16)
    cfg.model.pretrained = str(pth)
    cfg.data.image_size = (64, 64)
    cfg.train.batch_size = 8
    cfg.train.ema_decay = 0.99
    cfg.train.mixed_precision = False
    cfg.train.output_dir = str(tmp_path / "run")
    tr = Trainer(cfg, device="cpu")
    own = tr.model.state_dict()
    for k, v in sd.items():
        if not k.startswith("fc."):
            assert torch.equal(own[f"backbone.{k}"], v), k
    for e, p in zip(tr.state.ema, tr.model.parameters()):
        assert torch.equal(e, p)


def _randomize(tree, rs):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rs)
            continue
        v = np.asarray(v, np.float32)
        if k in ("bias", "mean"):
            v = rs.normal(0, 0.1, v.shape)
        elif k in ("scale", "var"):
            v = rs.uniform(0.5, 1.5, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("objectness,reg_max", [(False, 16), (True, 4)],
                         ids=["detect", "objectness"])
def test_detect_head_matches_jax(objectness, reg_max):
    rs = np.random.RandomState(3)
    feats = [rs.randn(2, 8, 8, 32).astype(np.float32),
             rs.randn(2, 4, 4, 48).astype(np.float32)]
    jh = JDetectHead(num_classes=3, reg_max=reg_max, strides=(8, 16),
                     objectness=objectness, dtype=jnp.float32)
    jf = [jnp.asarray(f) for f in feats]
    v = jax.tree_util.tree_map(
        np.asarray, jh.init(jax.random.PRNGKey(0), jf, train=False))
    v = _randomize(v, np.random.RandomState(4))
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    want_train, _ = jh.apply(jv, jf, train=True, mutable=["batch_stats"])
    want_dec = jh.apply(jv, jf, train=False)

    th = DetectHead((32, 48), num_classes=3, reg_max=reg_max,
                    strides=(8, 16), objectness=objectness)
    th.load_state_dict(convert.from_flax_detect_head(v))
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        th.eval()
        dec = th(tf)
        th.train()
        maps = th(tf)
    assert dec.shape == (2, 80, 4 + 3)
    scores = dec[..., 4:]
    assert bool(((scores >= 0) & (scores <= 1)).all())
    for g, w in zip(maps, want_train):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() \
            <= 1e-4 * np.abs(np.asarray(w)).max()
    w = np.asarray(want_dec)
    assert np.abs(dec.numpy() - w).max() <= 1e-4 * np.abs(w).max()
