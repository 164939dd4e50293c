"""The 4-image mosaic for the single-stage (YOLO-pose) family, on the
device inside the train step (counterpart of tpupose/ops/mosaic.py).

Each output image picks a centre (cy, cx) and three partner images (three
batch permutations); each quadrant shows one whole source image squeezed
into it, so no instance is cut and the labels move by one affine map a
quadrant. The 4M candidate instances are repacked valid-first (a stable
sort of the mask) into the M slots; real instances that do not fit are
counted in `dropped`. Shapes stay static end to end.

Per output pixel the source is the quadrant's image, sampled bilinearly
at the inverse of the label map. JAX samples all four sources and keeps
the quadrant's; here only the quadrant's source is sampled, with the
same arithmetic, so the values are the same.

Random draws (`draw_mosaic`): three permutations of the batch, the
centres in U(center_range) and a U(0, 1) per image that applies the
mosaic where it is below `prob`. The JAX package draws the same
distributions from jax.random; the bits differ, so the functions take
the draws as an argument.
"""

from __future__ import annotations

import torch


def draw_mosaic(generator: torch.Generator, batch: int,
                center_range=(0.35, 0.65)) -> dict:
    """{"perms": (3, B) int64, "centers": (B, 2) (cy, cx) fractions,
    "apply": (B,) U(0, 1)} on the generator's device."""
    dev = generator.device
    perms = torch.stack([torch.randperm(batch, generator=generator,
                                        device=dev) for _ in range(3)])
    lo, hi = center_range
    centers = lo + (hi - lo) * torch.rand((batch, 2), generator=generator,
                                          device=dev)
    apply = torch.rand((batch,), generator=generator, device=dev)
    return {"perms": perms, "centers": centers, "apply": apply}


def _canvas(imgs_f, perms, cy, cx):
    """imgs_f (B, H, W, C) float32; perms (B, 4) source per quadrant [TL,
    TR, BL, BR]; cy/cx (B,) the centre in pixels -> (B, H, W, C)."""
    B, H, W, _ = imgs_f.shape
    dev = imgs_f.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    cy, cx = cy[:, None, None], cx[:, None, None]
    top = yy < cy
    left = xx < cx
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    y0 = torch.where(top, zero, cy)
    x0 = torch.where(left, zero, cx)
    hq = torch.where(top, cy, H - cy)
    wq = torch.where(left, cx, W - cx)
    # pixel centres: the exact inverse of the label map of _quad_params
    sy = (yy + 0.5 - y0) / torch.clamp_min(hq, 1.0) * H - 0.5
    sx = (xx + 0.5 - x0) / torch.clamp_min(wq, 1.0) * W - 0.5
    sel = (~top).to(torch.int64) * 2 + (~left).to(torch.int64)   # (B, H, W)
    src = perms.gather(1, sel.reshape(B, -1)).reshape(sel.shape)
    iy0 = torch.floor(sy).to(torch.int64).clamp(0, H - 1)
    ix0 = torch.floor(sx).to(torch.int64).clamp(0, W - 1)
    iy1 = torch.clamp_max(iy0 + 1, H - 1)
    ix1 = torch.clamp_max(ix0 + 1, W - 1)
    wy = (sy - iy0).clamp(0.0, 1.0)[..., None]
    wx = (sx - ix0).clamp(0.0, 1.0)[..., None]
    a = imgs_f[src, iy0, ix0]
    b = imgs_f[src, iy0, ix1]
    c = imgs_f[src, iy1, ix0]
    d = imgs_f[src, iy1, ix1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _quad_params(cy, cx, H, W):
    """Per-quadrant label maps x' = x * sx + x0 (pixel centres, the -0.5
    + 0.5 s terms folded into x0/y0). cy/cx (B,) -> four (B, 4)."""
    z = torch.zeros_like(cy)
    sy = torch.stack([cy, cy, H - cy, H - cy], -1) / H
    sx = torch.stack([cx, W - cx, cx, W - cx], -1) / W
    y0 = torch.stack([z, z, cy, cy], -1) + 0.5 * sy - 0.5
    x0 = torch.stack([z, cx, z, cx], -1) + 0.5 * sx - 0.5
    return y0, x0, sy, sx


def mosaic_augment(images, boxes, classes, keypoints, instance_mask, draws,
                   prob: float = 1.0):
    """The 4-image mosaic. images (B, H, W, 3) uint8/float, boxes (B, M, 4)
    xyxy px, classes (B, M), keypoints (B, M, K, 3) px + vis,
    instance_mask (B, M); draws from `draw_mosaic`. Returns (images,
    boxes, classes, keypoints, instance_mask, dropped), the same shapes
    and dtypes, `dropped` the real instances (over the batch) that did
    not fit the M slots, a float32 device scalar."""
    B, H, W = images.shape[:3]
    M = boxes.shape[1]
    dev = images.device
    imgs_f = images.to(torch.float32)
    perms = torch.cat([torch.arange(B, device=dev)[:, None],
                       draws["perms"].to(dev).T], 1)             # (B, 4)
    cyx = draws["centers"].to(dev, torch.float32)
    cy, cx = cyx[:, 0] * H, cyx[:, 1] * W
    canvas = _canvas(imgs_f, perms, cy, cx)

    y0, x0, sy, sx = _quad_params(cy, cx, H, W)                  # (B, 4)
    bx, kp = boxes[perms], keypoints[perms]          # (B,4,M,4), (B,4,M,K,3)
    cl, mk = classes[perms], instance_mask[perms]                # (B, 4, M)
    sx2, x02 = sx[..., None], x0[..., None]
    sy2, y02 = sy[..., None], y0[..., None]
    bx = torch.stack([bx[..., 0] * sx2 + x02, bx[..., 1] * sy2 + y02,
                      bx[..., 2] * sx2 + x02, bx[..., 3] * sy2 + y02], -1)
    kp = torch.cat([kp[..., 0:1] * sx2[..., None, None] + x02[..., None, None],
                    kp[..., 1:2] * sy2[..., None, None] + y02[..., None, None],
                    kp[..., 2:]], -1)
    # repack the 4M candidates valid-first into M slots
    bx, kp = bx.reshape(B, 4 * M, 4), kp.reshape(B, 4 * M, *kp.shape[3:])
    cl, mk = cl.reshape(B, 4 * M), mk.reshape(B, 4 * M)
    order = torch.sort(-mk.to(torch.float32), dim=1, stable=True).indices
    keep = order[:, :M]
    m_mk = mk.gather(1, keep)
    mkf = mk.to(torch.float32)
    m_drop = torch.clamp_min(mkf.sum(1) - m_mk.to(torch.float32).sum(1), 0.0)
    m_bx = bx.gather(1, keep[..., None].expand(B, M, 4))
    m_cl = cl.gather(1, keep)
    m_kp = kp.gather(1, keep[..., None, None].expand(B, M, *kp.shape[2:]))

    apply = draws["apply"].to(dev) < prob                          # (B,)
    out_img = torch.where(apply[:, None, None, None], canvas, imgs_f)
    if not images.dtype.is_floating_point:
        out_img = torch.round(out_img).clamp(0, 255)
    aM = apply[:, None]
    return (out_img.to(images.dtype),
            torch.where(aM[..., None], m_bx, boxes),
            torch.where(aM, m_cl, classes),
            torch.where(aM[..., None, None], m_kp, keypoints),
            torch.where(aM, m_mk, instance_mask),
            torch.where(apply, m_drop, torch.zeros_like(m_drop)).sum())


def mosaic_augment_normalized(images, boxes, classes, keypoints,
                              instance_mask, draws, prob: float = 1.0):
    """`mosaic_augment` for the YOLO train batch: boxes normalized cxcywh
    and keypoint x/y normalized to [0, 1]; converted to pixel xyxy and
    back around the mosaic."""
    H, W = images.shape[1:3]
    cx, cy, w, h = boxes.unbind(-1)
    px_boxes = torch.stack([(cx - w / 2) * W, (cy - h / 2) * H,
                            (cx + w / 2) * W, (cy + h / 2) * H], -1)
    kscale = torch.tensor([W, H, 1.0], dtype=keypoints.dtype,
                          device=keypoints.device)
    images, px_boxes, classes, px_kpts, instance_mask, dropped = \
        mosaic_augment(images, px_boxes, classes, keypoints * kscale,
                       instance_mask, draws, prob=prob)
    x1, y1, x2, y2 = px_boxes.unbind(-1)
    boxes = torch.stack([(x1 + x2) / (2 * W), (y1 + y2) / (2 * H),
                         (x2 - x1) / W, (y2 - y1) / H], -1)
    return images, boxes, classes, px_kpts / kscale, instance_mask, dropped
