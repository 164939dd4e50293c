"""Plain float32 formulas shared by the references: crop normalisation,
flip-test merge, DARK decode, the crop-to-source map, the train step's
affine warp, colour jitter, Gaussian targets, JointsMSE, global-norm
clipping and Adam(W), and the fake-fp8 rounding of the control.

Written from the published methods (MSRA SimpleBaseline, DARK
arXiv:1910.06278, Adam / AdamW) in plain torch. Nothing here imports the
program under test; every function takes tensors and returns tensors.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# COCO-17 left/right keypoint pairs
COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16))


# -- precision of the control ---------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude mapped to 448, e4m3's largest finite value), in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(x.dtype)


class _FP8Round(torch.autograd.Function):
    """fp8 rounding of a product's operand going forward and of the
    gradient coming back through it."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """The control's precision, one step below bf16: x in fp8 e4m3, and
    where gradients are taken, the gradient through it in fp8 too."""
    return _FP8Round.apply(x) if x.requires_grad else _fp8(x)


def quant_or_id(quant: bool):
    return fp8_round if quant else (lambda t: t)


# -- serving ----------------------------------------------------------------

def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 NCHW, ImageNet mean / std."""
    x = images_u8.float() / 255.0
    m = torch.tensor(IMAGENET_MEAN, device=x.device)
    s = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def flip_back(hm_flipped: torch.Tensor, pairs=COCO_FLIP_PAIRS) -> torch.Tensor:
    """Heatmaps (B, K, H, W) of a horizontally mirrored crop -> the
    unmirrored crop's: width reversed, left/right joints swapped, then
    shifted one pixel right (the classic flip test, without UDP)."""
    hm = hm_flipped.flip(-1)
    perm = list(range(hm.shape[1]))
    for a, b in pairs:
        perm[a], perm[b] = b, a
    hm = hm[:, perm]
    return torch.cat([hm[..., :1], hm[..., :-1]], dim=-1)


def flip_merged(forward, x: torch.Tensor) -> torch.Tensor:
    """Flip-test heatmaps: mean of forward(x) and the un-flipped
    forward of the mirrored input. x NCHW."""
    return 0.5 * (forward(x) + flip_back(forward(x.flip(-1))))


def _taps(kernel: int, sigma: float, device) -> torch.Tensor:
    half = kernel // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-xs ** 2 / (2.0 * sigma * sigma))
    return k / k.sum()


def blur(hm: torch.Tensor, kernel: int = 11, sigma: float = 2.0):
    """Separable zero-padded Gaussian blur of (B, K, H, W) maps."""
    B, K, H, W = hm.shape
    k = _taps(kernel, sigma, hm.device)
    x = hm.reshape(B * K, 1, H, W)
    x = torch.nn.functional.conv2d(x, k.view(1, 1, -1, 1),
                                   padding=(kernel // 2, 0))
    x = torch.nn.functional.conv2d(x, k.view(1, 1, 1, -1),
                                   padding=(0, kernel // 2))
    return x.reshape(B, K, H, W)


def argmax_first(hm: torch.Tensor):
    """(B, K, H, W) -> integer (x, y) of the first maximum in row-major
    order (B, K, 2) and the maxima (B, K)."""
    B, K, H, W = hm.shape
    flat = hm.reshape(B, K, H * W)
    top = flat.amax(-1)
    idx = torch.arange(H * W, device=hm.device)
    first = torch.where(flat == top[..., None], idx, H * W).amin(-1)
    return torch.stack([first % W, first // W], -1), top


def dark_decode(hm: torch.Tensor, kernel: int = 11, sigma: float = 2.0,
                with_posed: bool = False):
    """DARK: argmax, then one Newton step on log(blurred map) at it, the
    offset clamped to one pixel; border and non-positive peaks keep the
    argmax, a map whose maximum is <= 0 gives (-1, -1). Returns float32
    coords (B, K, 2) in heatmap pixels and scores (B, K) = the maxima;
    with_posed also (B, K) bool: the step is well posed (an inner peak at
    a maximum of the blurred log map, the step under half a pixel on
    each axis)."""
    B, K, H, W = hm.shape
    ij, top = argmax_first(hm)
    coords = torch.where((top > 0)[..., None], ij.float(),
                         torch.full_like(ij, -1).float())
    lg = torch.log(blur(hm, kernel, sigma).clamp_min(1e-10))
    flat = lg.reshape(B, K, H * W)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()

    def v(dx, dy):
        x = (xi + dx).clamp(0, W - 1)
        y = (yi + dy).clamp(0, H - 1)
        return torch.gather(flat, -1, (y * W + x)[..., None])[..., 0]

    c0 = v(0, 0)
    gx = 0.5 * (v(1, 0) - v(-1, 0))
    gy = 0.5 * (v(0, 1) - v(0, -1))
    hxx = v(1, 0) - 2 * c0 + v(-1, 0)
    hyy = v(0, 1) - 2 * c0 + v(0, -1)
    hxy = 0.25 * (v(1, 1) - v(1, -1) - v(-1, 1) + v(-1, -1))
    det = hxx * hyy - hxy * hxy
    ok = det.abs() > 1e-12
    det = torch.where(ok, det, torch.ones_like(det))
    off = torch.stack([-(hyy * gx - hxy * gy) / det,
                       -(hxx * gy - hxy * gx) / det], -1)
    off = torch.where(ok[..., None], off, torch.zeros_like(off))
    off = off.clamp(-1.0, 1.0)
    inner = ((coords[..., 0] >= 1) & (coords[..., 0] <= W - 2)
             & (coords[..., 1] >= 1) & (coords[..., 1] <= H - 2))
    out = coords + off * inner[..., None], top
    if not with_posed:
        return out
    posed = (inner & ok & (hxx < 0) & (hyy < 0) & (det > 0)
             & (off.abs() < 0.5).all(-1))
    return (*out, posed)


def to_source(coords: torch.Tensor, centers: torch.Tensor,
              scales: torch.Tensor, hm_hw) -> torch.Tensor:
    """Heatmap pixels (B, K, 2) -> source pixels, for crops of the given
    centers and scales (B, 2) (w, h in source pixels), rotation 0: the
    heatmap's centre (W/2, H/2) maps to the crop's centre."""
    H, W = hm_hw
    step = scales / torch.tensor([float(W), float(H)], device=scales.device)
    mid = torch.tensor([W * 0.5, H * 0.5], device=scales.device)
    return centers[:, None, :] + (coords - mid) * step[:, None, :]


def from_source(src: torch.Tensor, centers: torch.Tensor,
                scales: torch.Tensor, hm_hw) -> torch.Tensor:
    """The inverse of `to_source`."""
    H, W = hm_hw
    step = scales / torch.tensor([float(W), float(H)], device=scales.device)
    mid = torch.tensor([W * 0.5, H * 0.5], device=scales.device)
    return (src - centers[:, None, :]) / step[:, None, :] + mid


def best_around(hm: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """The largest value of maps (B, K, H, W) on the 3 x 3 pixels about
    the pixel nearest one point (B, K, 2) each, clamped into the map. A
    DARK location lies within one pixel of its argmax on each axis, so
    these pixels hold that argmax."""
    B, K, H, W = hm.shape
    flat = hm.reshape(B, K, H * W)
    cx, cy = torch.round(xy[..., 0]), torch.round(xy[..., 1])
    best = None
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            x = (cx + dx).clamp(0, W - 1).long()
            y = (cy + dy).clamp(0, H - 1).long()
            v = torch.gather(flat, -1, (y * W + x)[..., None])[..., 0]
            best = v if best is None else torch.maximum(best, v)
    return best


# -- training ---------------------------------------------------------------

def augment_matrices(mult, rot_deg, hw):
    """(B,) scale multipliers and rotations -> (B, 2, 3) output->source
    matrices about the crop centre (W/2, H/2)."""
    H, W = hw
    th = torch.deg2rad(rot_deg.float())
    c, s = torch.cos(th), torch.sin(th)
    A = mult.float()[:, None, None] * torch.stack(
        [torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    ctr = torch.tensor([W * 0.5, H * 0.5], device=A.device)
    t = ctr[None] - torch.einsum("bij,j->bi", A, ctr)
    return torch.cat([A, t[..., None]], -1)


def warp_bilinear(images, mats, out_hw):
    """(B, H, W, C) uint8 crops, (B, 2, 3) output->source matrices ->
    (B, Ho, Wo, C) float32: bilinear, zero outside the source."""
    B, H, W, C = images.shape
    Ho, Wo = out_hw
    img = images.float().reshape(B, H * W, C)
    m = mats.float()
    ys = torch.arange(Ho, dtype=torch.float32, device=img.device)
    xs = torch.arange(Wo, dtype=torch.float32, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    sx = (m[:, 0, 0, None, None] * gx + m[:, 0, 1, None, None] * gy
          + m[:, 0, 2, None, None])
    sy = (m[:, 1, 0, None, None] * gx + m[:, 1, 1, None, None] * gy
          + m[:, 1, 2, None, None])
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]

    def tap(yy, xx):
        ok = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
        v = torch.gather(img, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return v.reshape(B, Ho, Wo, C) * ok[..., None]

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def move_joints(joints, vis, mult, rot_deg, hm_hw):
    """Joints (B, K, 2) in heatmap pixels under the crop's augmentation:
    the inverse scale-rotation about the heatmap centre; a joint that
    leaves the map gets visibility 0."""
    Hh, Wh = hm_hw
    th = torch.deg2rad(rot_deg.float())
    c, s = torch.cos(th), torch.sin(th)
    Ainv = (1.0 / mult.float())[:, None, None] * torch.stack(
        [torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
    ctr = torch.tensor([Wh * 0.5, Hh * 0.5], device=joints.device)
    j = torch.einsum("bij,bkj->bki", Ainv, joints.float() - ctr) + ctr
    inside = ((j[..., 0] >= 0) & (j[..., 0] < Wh)
              & (j[..., 1] >= 0) & (j[..., 1] < Hh))
    return j, vis * inside.to(vis.dtype)


def jitter_normalize(x01, bright, contrast, satur):
    """float (B, H, W, 3) in [0, 1] -> brightness, contrast about the
    image mean, saturation about the pixel's grey, clipped to [0, 1],
    then ImageNet-normalised, NCHW float32."""
    x = x01 * bright[:, None, None, None]
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * contrast[:, None, None, None] + mean
    grey = x.mean(dim=-1, keepdim=True)
    x = ((x - grey) * satur[:, None, None, None] + grey).clamp(0.0, 1.0)
    m = torch.tensor(IMAGENET_MEAN, device=x.device)
    s = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2).contiguous()


def gaussian_targets(joints, vis, hm_hw, sigma: float = 2.0):
    """Unbiased Gaussian targets (B, K, H, W) at float joint centres and
    their weights (B, K): labelled and within 3 sigma + 1 of the map."""
    H, W = hm_hw
    ys = torch.arange(H, dtype=torch.float32, device=joints.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=joints.device)[None]
    mx = joints[..., 0, None, None]
    my = joints[..., 1, None, None]
    g = torch.exp(-((xs - mx) ** 2 + (ys - my) ** 2) / (2 * sigma * sigma))
    r = 3 * sigma + 1
    x, y = joints[..., 0], joints[..., 1]
    w = ((vis > 0) & (x - r < W) & (x + r >= 0) & (y - r < H)
         & (y + r >= 0)).float()
    return g * w[..., None, None], w


def joints_mse(pred, target, weight):
    """0.5 x squared error per joint, weighted, over the weights' sum
    (at least 1) times the pixels of a map. (B, K, H, W) maps."""
    se = (pred - target) ** 2 * weight[..., None, None]
    per_map = pred.shape[2] * pred.shape[3]
    return 0.5 * se.sum() / (weight.sum().clamp_min(1.0) * per_map)


def clip_global(grads, max_norm: float):
    """Scale the gradients by max_norm / norm where their global norm
    reaches max_norm (optax's clip_by_global_norm)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale for g in grads], norm


def adam_update(p, g, m, v, t, lr, b1, b2, eps, weight_decay=0.0,
                decoupled=False):
    """One Adam step (t counts from 1); with `decoupled` AdamW's decay
    p *= 1 - lr * weight_decay first. Returns new (p, m, v)."""
    if decoupled and weight_decay:
        p = p * (1.0 - lr * weight_decay)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1 ** t)
    vh = v / (1 - b2 ** t)
    return p - lr * mh / (vh.sqrt() + eps), m, v
