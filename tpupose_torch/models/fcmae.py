"""FCMAE, fully convolutional masked-autoencoder pretraining
(counterpart of tpupose/models/fcmae.py).

  - `gen_random_mask(generator, batch, num_patches, mask_ratio)`: a
    per-image random patch mask, 1 = masked, exactly
    round(mask_ratio * num_patches) ones a row, drawn from an explicit
    torch.Generator;
  - `patchify(imgs, p)`: (B, H, W, 3) -> (B, L, p*p*3);
  - `FCMAE`: a dense ConvNeXtV2 encoder (models/backbones/convnext.py,
    v2 blocks) with the patch mask applied twice, as the JAX code does:
    once after the stem's LayerNorm, upsampled by nearest x(p/4) (which
    at an integer factor is repeat_interleave), and once on the last
    stage's map; then `decoder_embed` (1x1), the learned `mask_token` in
    the masked cells, one ConvNeXt block (`decoder_block`, v1 with its
    layer scale `gamma`), and `pred` (1x1 to p*p*3, in float32). The
    loss is the masked mean of the per-patch MSE against the pixels,
    normalized per patch with norm_pix (population variance, as
    jnp.var).

`forward(imgs, mask=None, generator=None)` takes NHWC images in [0, 1]
(or uint8, divided by 255 here) and returns (loss, {"pred": (B, L,
p*p*3), "mask": (B, L)}); it takes the mask as an argument, as JAX's
does, or draws one from `generator`. The dtype policy is the other
models'. No hand kernel runs here: ConvNeXt is cuDNN's convolutions.
"""

from __future__ import annotations

import torch
from torch import nn

from tpupose_torch._device import autocast_inputs, resolve_device
from tpupose_torch.models.backbones.convnext import CONVNEXT_SIZES, ConvNeXt
from tpupose_torch.models.necks import ConvNeXtBlock
from tpupose_torch.models.yolo_head import Float32Conv


def gen_random_mask(generator: torch.Generator, batch: int,
                    num_patches: int, mask_ratio: float = 0.6,
                    device=None) -> torch.Tensor:
    """(batch, num_patches) float32 mask, 1 = masked."""
    n_mask = int(round(num_patches * mask_ratio))
    noise = torch.rand((batch, num_patches), generator=generator,
                       device=device)
    ranks = noise.argsort(1).argsort(1)
    return (ranks < n_mask).float()


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)(W/p), p*p*C), patches row-major."""
    B, H, W, C = imgs.shape
    p = patch_size
    x = imgs.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


class FCMAE(nn.Module):
    def __init__(self, size: str = "atto", patch_size: int = 32,
                 mask_ratio: float = 0.6, decoder_dim: int = 512,
                 norm_pix: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        dev = resolve_device(device)
        if size not in CONVNEXT_SIZES:
            raise ValueError(f"unknown convnext size {size!r}; have "
                             f"{sorted(CONVNEXT_SIZES)}")
        if patch_size % 4:
            raise ValueError(f"patch_size must be a multiple of the stem's "
                             f"stride 4, got {patch_size}")
        arch = CONVNEXT_SIZES[size]
        self.patch_size, self.mask_ratio = patch_size, mask_ratio
        self.norm_pix = norm_pix
        self.compute_dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.encoder = ConvNeXt(arch["depths"], arch["dims"], v2=True)
        self.decoder_embed = nn.Conv2d(arch["dims"][-1], decoder_dim, 1)
        self.mask_token = nn.Parameter(torch.zeros(1, decoder_dim, 1, 1))
        self.decoder_block = ConvNeXtBlock(decoder_dim, v2=False)
        self.pred = Float32Conv(decoder_dim, patch_size * patch_size * 3, 1)
        self.to(device=dev, dtype=self.param_dtype)
        self.pred.float()
        self.eval()

    def forward(self, imgs, mask=None, generator=None):
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        B, H, W, _ = imgs.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size {(H, W)} is not a multiple of the "
                             f"patch size {p}")
        hp, wp = H // p, W // p
        L = hp * wp
        if mask is None:
            mask = gen_random_mask(generator, B, L, self.mask_ratio,
                                   device=imgs.device)
        mask2d = mask.reshape(B, hp, wp)
        f = p // 4
        stem_mask = mask2d.repeat_interleave(f, 1).repeat_interleave(f, 2)
        x, ctx = autocast_inputs(imgs.permute(0, 3, 1, 2), self.compute_dtype,
                                 self.param_dtype)
        with ctx:
            z = self.encoder(x, mask=stem_mask)[-1]            # (B, D, hp, wp)
            z = z * (1.0 - mask2d[:, None].to(z.dtype))
            zd = self.decoder_embed(z)
            m = mask2d[:, None].to(zd.dtype)
            zd = zd * (1 - m) + self.mask_token.to(zd.dtype) * m
            pred = self.pred(self.decoder_block(zd))           # float32
        pred = pred.permute(0, 2, 3, 1).reshape(B, L, p * p * 3)
        target = patchify(imgs.float(), p)
        if self.norm_pix:
            mu = target.mean(-1, keepdim=True)
            var = target.var(-1, keepdim=True, correction=0)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        loss = ((pred - target) ** 2).mean(-1)                 # (B, L)
        loss = (loss * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return loss, {"pred": pred, "mask": mask}


@torch.no_grad()
def init_fcmae_like_flax(model: FCMAE, g: torch.Generator):
    """flax's initializers drawn from `g` on the CPU (the init of
    tpupose's FCMAE): lecun_normal conv and dense kernels, zero biases,
    unit LayerNorm scales, GRN zeros, the decoder block's layer scale
    1e-6, the mask token truncated_normal(0.02)."""
    from tpupose_torch.models.simple_baseline import init_like_flax

    init_like_flax(model, g)
    for m in model.modules():
        if isinstance(m, ConvNeXtBlock) and m.gamma is not None:
            m.gamma.fill_(1e-6)
    w = torch.empty(model.mask_token.shape)
    nn.init.trunc_normal_(w, 0.0, 0.02, -0.04, 0.04, generator=g)
    model.mask_token.copy_(w)
