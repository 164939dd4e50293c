"""Associative-embedding grouping decode on the device (counterpart of
tpupose/ops/ae_decode.py; Newell et al., NeurIPS 2017).

- `find_peaks`: per-joint local maxima (3x3 max-pool equality, one
  survivor per exact plateau) and the top P by score per joint, in
  descending order with ties to the lower flat index (JAX's `lax.top_k`:
  a stable descending sort; `torch.topk` promises no order among ties,
  which are common on int8-served maps).
- `decode_ae`: a loop over the K joint types in anatomical order; per
  joint, a P-step loop walks the candidates by descending score and
  either joins the nearest existing group by |tag - group mean| (greedy,
  one candidate a group a joint) or claims an empty group slot. All
  state is dense (B, P) tensors on the device: no host round trip, and
  K * P steps of small ops (510 at K = 17, P = 30).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BIG = 1e9


def find_peaks(heatmaps, max_people: int):
    """Per-joint local maxima. heatmaps (B, K, H, W) float32 -> (coords
    (B, K, P, 2) xy in heatmap px, scores (B, K, P), flat_idx (B, K, P)
    int64), by descending score.

    A pixel is a peak where it equals its 3x3 window's max; of the masked
    pixels of one window only the highest linear index survives (exact
    plateaus would each seed a person). The linear indices are pooled as
    float32, exact below 2^24 pixels; max_pool2d's -inf padding lies
    below the -1 of the unmasked pixels, as JAX's -1 window init does."""
    B, K, H, W = heatmaps.shape
    if H * W >= 2 ** 24:
        raise ValueError(f"find_peaks: {H}x{W} map has too many pixels for "
                         "exact float32 indices")
    hm = heatmaps.float()
    pooled = F.max_pool2d(hm, 3, 1, 1)
    mask = hm >= pooled
    lin = torch.arange(H * W, dtype=torch.float32,
                       device=hm.device).reshape(1, 1, H, W)
    idxm = torch.where(mask, lin, torch.full_like(lin, -1.0))
    pooled_idx = F.max_pool2d(idxm, 3, 1, 1)
    peaks = torch.where(mask & (idxm == pooled_idx), hm,
                        torch.zeros_like(hm))
    flat = peaks.reshape(B, K, H * W)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[..., :max_people], idx[..., :max_people]
    xs = (idx % W).float()
    ys = (idx // W).float()
    return torch.stack([xs, ys], -1), scores, idx


def decode_ae(heatmaps, tags, max_people: int = 8,
              score_threshold: float = 0.1, tag_threshold: float = 1.0,
              refine: bool = True):
    """Group per-joint peaks into people by tag distance.

    heatmaps, tags (B, K, H, W) float32. Returns a dict of device
    tensors: coords (B, P, K, 2) heatmap px, scores (B, P, K) (0 = joint
    absent), person_scores (B, P), person_mask (B, P) bool; P =
    max_people, person slots in creation order."""
    from tpupose_torch.ops.decode import quarter_offset_refine

    B, K, H, W = heatmaps.shape
    P = max_people
    dev = heatmaps.device
    coords, scores, idx = find_peaks(heatmaps, P)
    tagv = torch.gather(tags.float().reshape(B, K, H * W), 2, idx)
    if refine:
        coords = quarter_offset_refine(heatmaps.float(), coords)

    g_tag_sum = torch.zeros(B, P, device=dev)
    g_cnt = torch.zeros(B, P, device=dev)
    slots = torch.arange(P, device=dev)
    out_xy, out_s = [], []
    for k in range(K):
        c_xy, c_score, c_tag = coords[:, k], scores[:, k], tagv[:, k]
        g_mean = g_tag_sum / g_cnt.clamp_min(1.0)
        # candidate -> group cost, frozen at the joint's entry state (a
        # group made during this joint is taken, its stale mean unused)
        cost = (c_tag[:, :, None] - g_mean[:, None, :]).abs()  # (B, P, P)
        cost = torch.where((g_cnt > 0)[:, None, :], cost,
                           torch.full_like(cost, _BIG))
        valid_all = c_score > score_threshold                  # (B, P)
        jc = torch.zeros(B, P, 2, device=dev)
        js = torch.zeros(B, P, device=dev)
        taken = torch.zeros(B, P, device=dev)
        for p in range(P):
            c = cost[:, p] + _BIG * taken
            cbest = c.amin(-1, keepdim=True)
            best = c.argmin(-1, keepdim=True)      # the first minimum
            valid = valid_all[:, p:p + 1]
            match = valid & (cbest < tag_threshold)
            empty = (g_cnt <= 0) & (taken == 0)
            slot_new = empty.float().argmax(-1, keepdim=True)
            can_new = valid & ~match & empty.any(-1, keepdim=True)
            slot = torch.where(match, best, slot_new)
            onehot = ((slots == slot) & (match | can_new)).float()
            g_tag_sum = g_tag_sum + onehot * c_tag[:, p:p + 1]
            g_cnt = g_cnt + onehot
            hit = onehot > 0
            jc = torch.where(hit[..., None], c_xy[:, p, None, :], jc)
            js = torch.where(hit, c_score[:, p:p + 1], js)
            taken = torch.maximum(taken, onehot)
        out_xy.append(jc)
        out_s.append(js)
    out_coords = torch.stack(out_xy, 2)                      # (B, P, K, 2)
    out_scores = torch.stack(out_s, 2)                       # (B, P, K)
    found = (out_scores > 0).float().sum(-1)
    person_scores = out_scores.sum(-1) / found.clamp_min(1.0)
    return {"coords": out_coords, "scores": out_scores,
            "person_scores": person_scores, "person_mask": g_cnt > 0}
