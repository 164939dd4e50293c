"""FSKD, few-shot keypoint detection (counterpart of tpupose/models/fskd.py).

  - `FeatureExtractor`: DinoViT (models/backbones/vit.py) with the outputs
    of blocks depth//3 - 1, 2 depth//3 - 1 and depth - 1 (before the final
    norm); the CLS token and the first two maps' spatial means through
    `fc` (flax `Dense_0`), GELU and `cls_fuse`; the patch map through
    `patch_proj`. `CrossModalFeatureExtractor` adds a learned
    `modality_embed` row to both.
  - `compute_prototypes`: per-class masked means of support features.
  - `PrototypicalHead`: cosine logits (x temperature) of query features
    against prototypes, and keypoint `offset` (sigmoid, in [0, 1]) and
    `confidence` heads; `MultiPrototypicalHead` adds per-keypoint
    prototype similarities to the confidence.
  - `AttentionFusion` / `AdaptiveAttentionFusion`: query features fused
    with the prototypes by self-attention and gated attention over the
    joint token set, mixed by a learned (`mix`) or per-query (`strategy`)
    softmax.
  - `FSKD`: support and query CLS features -> prototypes -> adaptive
    fusion -> prototypical head; `fskd_episode_loss`; `maml_adapt`.

dtype policy, the other models': float32 master weights under bf16
autocast where `dtype` and `param_dtype` differ. As in JAX, some parts are
float32 whatever the model's dtype (autocast off, inputs cast): the
`offset`, `confidence` and `strategy` layers (kept float32 even in a bf16
build), the prototype and query norms, the cosine logits, the keypoint
similarities and the strategy mix. GELU is the tanh form.

On the card the ViT's attention is the flash kernel K8, its backward K8b
(ops/attention.fused_attention): each `encode` launches K8 once a block,
so one FSKD forward launches it 2 x depth times. The fusion's attention
is models/attention's plain product, as JAX's is XLA's.

`maml_adapt` runs the MAML inner loop functionally: torch.func's
functional_call on a dict of parameters, gradients by
torch.autograd.grad(..., create_graph=True), no module clone. The
adapted parameters stay differentiable: on the CPU an outer loss through
them gives the full second-order gradient. On the card the inner loop
runs K8 and K8b; K8b has no derivative of its own (as the TPU kernel's
backward has none), so a second-order backward through it raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from tpupose_torch._device import autocast_inputs, resolve_device
from tpupose_torch.losses.classify import (binary_cross_entropy_with_logits,
                                           cross_entropy)
from tpupose_torch.models.attention import Attention, GatedAttention
from tpupose_torch.models.backbones.vit import VIT_SIZES, DinoViT


def _float32(x):
    """An autocast-off region on x's device (for the float32 parts)."""
    return torch.autocast(x.device.type, enabled=False)


class Float32Linear(nn.Linear):
    """A Linear that computes in float32 whatever the autocast state."""

    def forward(self, x):
        with _float32(x):
            return super().forward(x.to(self.weight.dtype))


def _unit(x):
    """x / (||x||_2 + 1e-8) over the last axis, in float32."""
    x = x.float()
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class FeatureExtractor(nn.Module):
    """ViT -> (cls_feat (B, out_dim), patches (B, h, w, out_dim))."""

    def __init__(self, vit_size: str = "small", out_dim: int = 256):
        super().__init__()
        spec = VIT_SIZES[vit_size]
        depth, dim = spec["depth"], spec["dim"]
        self.ids = (depth // 3 - 1, 2 * depth // 3 - 1, depth - 1)
        self.backbone = DinoViT.from_size(vit_size, intermediates=self.ids)
        self.fc = nn.Linear(3 * dim, 2 * out_dim)
        self.cls_fuse = nn.Linear(2 * out_dim, out_dim)
        self.patch_proj = nn.Linear(dim, out_dim)

    def forward(self, x):
        out = self.backbone(x)
        inter = out["intermediates"]
        cls_multi = torch.cat([out["cls"]] + [inter[i].mean(dim=(1, 2))
                                              for i in self.ids[:-1]], -1)
        cls_feat = self.cls_fuse(F.gelu(self.fc(cls_multi),
                                        approximate="tanh"))
        return cls_feat, self.patch_proj(out["feature_map"])


class CrossModalFeatureExtractor(FeatureExtractor):
    """FeatureExtractor plus a learned embedding per modality."""

    def __init__(self, vit_size: str = "small", out_dim: int = 256,
                 num_modalities: int = 2):
        super().__init__(vit_size, out_dim)
        self.modality_embed = nn.Parameter(torch.zeros(num_modalities,
                                                       out_dim))

    def forward(self, x, modality_id: int = 0):
        cls_feat, patches = super().forward(x)
        m = self.modality_embed[modality_id].to(cls_feat.dtype)
        return cls_feat + m, patches + m


def compute_prototypes(support_feats, support_labels, n_way: int):
    """(S, ..., D) support features, (S,) labels in [0, n_way) ->
    (n_way, ..., D) per-class means (a class without support: zeros)."""
    onehot = F.one_hot(support_labels.long(), n_way).to(support_feats.dtype)
    tail = (1,) * (support_feats.dim() - 1)
    w = onehot.reshape((support_feats.shape[0], n_way) + tail)
    num = (support_feats[:, None] * w).sum(0)
    den = torch.clamp_min(onehot.sum(0).reshape((n_way,) + tail), 1e-6)
    return num / den


class PrototypicalHead(nn.Module):
    """query_feat (Q, D), prototypes (n_way, D) -> logits (Q, n_way),
    keypoints (Q, K, 2) in [0, 1], confidence (Q, K)."""

    def __init__(self, num_keypoints: int, dim: int = 256,
                 temperature: float = 10.0):
        super().__init__()
        self.num_keypoints, self.temperature = num_keypoints, temperature
        self.fc = nn.Linear(dim, dim)
        self.offset = Float32Linear(dim, 2 * num_keypoints)
        self.confidence = Float32Linear(dim, num_keypoints)

    def forward(self, query_feat, prototypes):
        with _float32(query_feat):
            logits = self.temperature * (_unit(query_feat)
                                         @ _unit(prototypes).T)
        h = F.gelu(self.fc(query_feat), approximate="tanh")
        kpts = torch.sigmoid(self.offset(h)).reshape(-1, self.num_keypoints,
                                                     2)
        return {"logits": logits, "keypoints": kpts,
                "confidence": self.confidence(h)}


class MultiPrototypicalHead(nn.Module):
    """PrototypicalHead (`base`) on class prototypes; the confidence also
    gets temperature x each keypoint's similarity to the class-weighted
    keypoint prototypes kpt_protos (n_way, K, D)."""

    def __init__(self, num_keypoints: int, dim: int = 256,
                 temperature: float = 10.0):
        super().__init__()
        self.temperature = temperature
        self.base = PrototypicalHead(num_keypoints, dim, temperature)

    def forward(self, query_feat, class_protos, kpt_protos):
        base = self.base(query_feat, class_protos)
        with _float32(query_feat):
            sim = torch.einsum("qd,nkd->qnk", _unit(query_feat),
                               _unit(kpt_protos))
            cls_w = torch.softmax(base["logits"], -1)
            kpt_sim = torch.einsum("qn,qnk->qk", cls_w, sim)
            conf = base["confidence"] + self.temperature * kpt_sim
        return dict(base, confidence=conf, kpt_similarity=kpt_sim)


class AttentionFusion(nn.Module):
    """query_feats (Q, D), prototypes (n_way, D) -> (Q, D): the input plus
    softmax(mix)-weighted self-attention and gated-attention outputs over
    the joint token set (in float32, as JAX's float32 `mix` promotes
    them)."""

    def __init__(self, dim: int = 256, num_heads: int = 4):
        super().__init__()
        self.self_attn = Attention(dim, num_heads)
        self.gate_attn = GatedAttention(dim, num_heads)
        self.mix = nn.Parameter(torch.zeros(2))

    def forward(self, query_feats, prototypes):
        Q = query_feats.shape[0]
        tokens = torch.cat([query_feats, prototypes], 0)[None]
        fused = self.self_attn(tokens)[0, :Q]
        gated = self.gate_attn(tokens)[0, :Q]
        a = torch.softmax(self.mix.float(), 0)
        return query_feats.float() + a[0] * fused.float() \
            + a[1] * gated.float()


class AdaptiveAttentionFusion(nn.Module):
    """Per-query strategy weights (`strategy`, float32) over the
    self-attention, gated-attention and identity paths."""

    def __init__(self, dim: int = 256, num_heads: int = 4):
        super().__init__()
        self.self_attn = Attention(dim, num_heads)
        self.gate_attn = GatedAttention(dim, num_heads)
        self.strategy = Float32Linear(dim, 3)

    def forward(self, query_feats, prototypes):
        Q = query_feats.shape[0]
        tokens = torch.cat([query_feats, prototypes], 0)[None]
        s1 = self.self_attn(tokens)[0, :Q]
        s2 = self.gate_attn(tokens)[0, :Q]
        a = torch.softmax(self.strategy(query_feats), -1)[..., None]
        with _float32(query_feats):
            stack = torch.stack([s1.float(), s2.float(),
                                 query_feats.float()], 1)   # (Q, 3, D)
            return (a * stack).sum(1).to(query_feats.dtype)


class FSKD(nn.Module):
    """Episodic few-shot keypoint detector: forward(support_imgs
    (S, H, W, 3), support_labels (S,), query_imgs (Q, H, W, 3)) -> the
    PrototypicalHead dict for the queries. Built on `device` (default
    "cuda"; raises if CUDA is absent) with parameters in `param_dtype`
    (default `dtype`)."""

    def __init__(self, n_way: int = 5, num_keypoints: int = 17,
                 dim: int = 256, vit_size: str = "small",
                 use_fusion: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.n_way = n_way
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.extractor = FeatureExtractor(vit_size, dim)
        self.fusion = AdaptiveAttentionFusion(dim) if use_fusion else None
        self.head = PrototypicalHead(num_keypoints, dim)
        self.to(device=dev, dtype=self.param_dtype)
        for m in self.modules():
            if isinstance(m, Float32Linear):
                m.float()
        self.eval()

    def encode(self, imgs):
        return self.extractor(imgs)[0]

    def forward(self, support_imgs, support_labels, query_imgs):
        dt = (self.compute_dtype, self.param_dtype)
        support_imgs, ctx = autocast_inputs(support_imgs, *dt)
        query_imgs, _ = autocast_inputs(query_imgs, *dt)
        with ctx:
            s_feat = self.encode(support_imgs)                 # (S, D)
            q_feat = self.encode(query_imgs)                   # (Q, D)
            protos = compute_prototypes(s_feat, support_labels, self.n_way)
            if self.fusion is not None:
                q_feat = self.fusion(q_feat, protos)
            return self.head(q_feat, protos)


@torch.no_grad()
def init_fskd_like_flax(model: FSKD, g: torch.Generator):
    """flax's initializers drawn from `g` on the CPU (the init of
    tpupose's FSKD): lecun_normal dense and conv kernels, zero biases,
    unit LayerNorm scales, the ViT's tokens truncated_normal(0.02) and
    layer scales 1e-5."""
    from tpupose_torch.models.simple_baseline import init_like_flax
    from tpupose_torch.models.vitpose import init_vit_like_flax

    init_like_flax(model, g)
    init_vit_like_flax(model.extractor.backbone, g)


def fskd_episode_loss(outputs, query_labels, query_kpts, query_vis,
                      kpt_weight: float = 10.0, conf_weight: float = 1.0):
    """CE over the classes + masked L1 of the keypoints + BCE of the
    confidence against visibility; (total, {"cls", "kpt", "conf"})."""
    ce = cross_entropy(outputs["logits"], query_labels).mean()
    m = (query_vis > 0).float()
    l1 = ((outputs["keypoints"].float() - query_kpts).abs().sum(-1)
          * m).sum() / torch.clamp_min(m.sum(), 1.0)
    conf = binary_cross_entropy_with_logits(outputs["confidence"], m).mean()
    return ce + kpt_weight * l1 + conf_weight * conf, {
        "cls": ce, "kpt": l1, "conf": conf}


def maml_adapt(model: FSKD, params, support_imgs, support_labels,
               support_kpts, support_vis, inner_lr: float = 0.01,
               inner_steps: int = 3) -> dict:
    """MAML inner loop: `inner_steps` SGD steps of the support loss (the
    support set as its own queries) on `params` ({name: tensor}, default
    the model's own), functionally. Returns the adapted {name: tensor},
    differentiable with respect to `params` (run the model on them with
    torch.func.functional_call). A parameter the loss does not reach
    stays as it is (JAX's zero gradient)."""
    params = dict(model.named_parameters() if params is None else params)
    buffers = dict(model.named_buffers())
    names = list(params)
    for _ in range(inner_steps):
        out = functional_call(model, {**params, **buffers},
                              (support_imgs, support_labels, support_imgs))
        loss, _ = fskd_episode_loss(out, support_labels, support_kpts,
                                    support_vis)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    create_graph=True, allow_unused=True)
        params = {n: params[n] if gr is None else params[n] - inner_lr * gr
                  for n, gr in zip(names, grads)}
    return params
