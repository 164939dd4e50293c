"""Associative Embedding for bottom-up multi-person pose (counterpart of
tpupose/losses/ae.py; Newell et al., NeurIPS 2017): one heatmap and one
scalar tag map per joint, multi-person Gaussian targets composed by max,
and the push/pull grouping loss over the tags gathered at the GT joints.

The targets render on the device from the padded (B, M, K, 3) instance
tensor (the yolo family's batch contract), a running max over the M
instance slots in one (B, K, H, W) buffer; the pull/push terms are
dense (B, M) / (B, M, M) reductions under the instance mask.
"""

from __future__ import annotations

import torch

from tpupose_torch.ops.heatmap import gaussian_heatmaps
from tpupose_torch.losses.normalize import local_count


def multi_person_heatmaps(keypoints, instance_mask, heatmap_size,
                          sigma: float = 2.0):
    """Max over instances of per-person Gaussians. keypoints (B, M, K, 3)
    normalized (x, y, vis); instance_mask (B, M). Returns (B, H, W, K)
    targets (the head's NHWC layout)."""
    H, W = heatmap_size
    scale = torch.tensor([W, H], dtype=torch.float32,
                         device=keypoints.device)
    joints = keypoints[..., :2].float() * scale                # (B, M, K, 2)
    vis = keypoints[..., 2] * instance_mask[..., None]         # (B, M, K)
    acc = torch.zeros(keypoints.shape[0], keypoints.shape[2], H, W,
                      device=keypoints.device)
    for m in range(keypoints.shape[1]):
        hm, _ = gaussian_heatmaps(joints[:, m], vis[:, m], (H, W), sigma)
        acc = torch.maximum(acc, hm)
    return acc.permute(0, 2, 3, 1)


def gather_tags(tags, keypoints, instance_mask):
    """Tag values at the (rounded) GT joint pixels. tags (B, H, W, K);
    keypoints (B, M, K, 3) normalized. Returns (tag_vals (B, M, K), valid
    (B, M, K) float): a joint whose rounded pixel is off the map, an
    unlabelled joint or a padded instance is not valid."""
    B, H, W, K = tags.shape
    scale = torch.tensor([W, H], dtype=torch.float32, device=tags.device)
    j = keypoints[..., :2].float() * scale
    xr, yr = torch.round(j[..., 0]), torch.round(j[..., 1])
    xi = xr.to(torch.int64).clamp(0, W - 1)
    yi = yr.to(torch.int64).clamp(0, H - 1)
    idx = yi * W + xi                                        # (B, M, K)
    flat = tags.reshape(B, H * W, K).transpose(1, 2)         # (B, K, HW)
    vals = torch.gather(flat, 2, idx.transpose(1, 2)).transpose(1, 2)
    in_map = (xr >= 0) & (xr <= W - 1) & (yr >= 0) & (yr <= H - 1)
    valid = ((keypoints[..., 2] > 0) & (instance_mask[..., None] > 0)
             & in_map)
    return vals, valid.float()


def ae_grouping_loss(tags, keypoints, instance_mask, tag_sigma: float = 1.0,
                     *, count=local_count):
    """Newell push/pull over reference embeddings: pull draws each
    person's joints to the person's mean tag, push is exp(-(h_m - h_n)^2
    / (2 sigma^2)) between distinct persons; both exact masked means over
    the padded instance slots, normalised by `count` of persons and of
    pairs (losses/normalize.py). Returns (pull, push)."""
    t, v = gather_tags(tags, keypoints, instance_mask)       # (B, M, K)
    cnt = v.sum(-1)                                          # (B, M)
    person = cnt > 0
    h = (t * v).sum(-1) / torch.clamp_min(cnt, 1.0)          # (B, M)
    pull_per = (((t - h[..., None]) ** 2) * v).sum(-1) \
        / torch.clamp_min(cnt, 1.0)
    n_person = person.float().sum()
    pull = (pull_per * person).sum() / count(n_person)
    d2 = (h[:, :, None] - h[:, None, :]) ** 2                # (B, M, M)
    eye = torch.eye(keypoints.shape[1], dtype=torch.bool,
                    device=tags.device)[None]
    pair = person[:, :, None] & person[:, None, :] & ~eye
    n_pair = pair.float().sum()
    push = (torch.exp(-d2 / (2.0 * tag_sigma ** 2)) * pair).sum() \
        / count(n_pair)
    return pull, push


def ae_loss(pred, keypoints, instance_mask, *, sigma: float = 2.0,
            tag_sigma: float = 1.0, pull_weight: float = 1e-3,
            push_weight: float = 1e-3, heatmap_weight: float = 1.0,
            count=local_count):
    """The bottom-up objective on a (B, H, W, 2K) prediction (channels
    [0:K] heatmaps, [K:2K] tags). Returns (loss, {"hm_loss", "pull",
    "push"}). Rows whose instance mask is all zero (the eval loader's
    padded rows) are left out of the heatmap term."""
    K = pred.shape[-1] // 2
    hm = pred[..., :K].float()
    tags = pred[..., K:].float()
    target = multi_person_heatmaps(keypoints, instance_mask,
                                   (pred.shape[1], pred.shape[2]), sigma)
    row = (instance_mask.sum(1) > 0).float()                 # (B,)
    per_row = ((hm - target) ** 2).mean(dim=(1, 2, 3))
    hm_loss = (per_row * row).sum() / count(row.sum())
    pull, push = ae_grouping_loss(tags, keypoints, instance_mask, tag_sigma,
                                  count=count)
    loss = heatmap_weight * hm_loss + pull_weight * pull + push_weight * push
    return loss, {"hm_loss": hm_loss, "pull": pull, "push": push}
