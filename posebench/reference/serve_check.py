"""The serving comparison: the program's keypoints and scores for a batch
of crops against the plain float32 reference's flip-merged heatmaps.

Random weights give heatmaps whose maxima can be nearly tied, so that
rounding moves the argmax between far-apart pixels; the served location
is therefore judged by what it is worth on the reference's map, as a
served token is judged by its logit and not by its identity. For each
crop and joint, with R the reference map's range (max - min):

  score_gap  |score - reference max| / R
             (normalisation, both forwards and the flip merge, the
             backbone and head, the decode's maximum);
  loc_gap    (reference max - the best reference value on the 3 x 3
             pixels about the served location) / R, the served source
             coordinate mapped back onto the heatmap grid (the argmax,
             the back-projection); those pixels hold the argmax the
             served DARK location came from; a served (-1, -1) sentinel
             is worth 0;
  coord_px   |served - reference DARK location| in heatmap pixels, the
             median over the joints whose DARK step is not in doubt: the
             reference peak higher by 2% of R than every other pixel of
             its map, and the Newton step at it well posed (a maximum of
             the blurred log map, the step under half a pixel on each
             axis, so not clamped); 0 where the sample has none. A step
             at a saddle or clamped at one pixel turns over on rounding,
             so its largest gap says nothing of the decode.

Each is the largest over the sampled crops and joints.
"""

from __future__ import annotations

import contextlib

import torch

from posebench.reference import common as R

CLEAR_MARGIN = 0.02


@torch.no_grad()
def reference_heatmaps(ref_module, P: dict, widths: dict, images_u8,
                       flip: bool, quant: bool = False, chunk: int = 32):
    """Flip-merged float32 heatmaps (B, K, H, W) of uint8 crops, computed
    `chunk` crops at a time, TF32 off."""
    out = []
    with no_tf32():
        for s in range(0, images_u8.shape[0], chunk):
            x = R.normalize(images_u8[s:s + chunk])

            def fwd(v):
                return ref_module.forward(P, v, widths, quant=quant)

            out.append(R.flip_merged(fwd, x) if flip else fwd(x))
    return torch.cat(out)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


class Gaps:
    """The gaps over the compared batches: running maxima, and the
    clear joints' coordinate gaps."""

    def __init__(self):
        self.score = self.loc = 0.0
        self.coord_gaps = []
        self.joints = self.clear = 0

    def result(self) -> dict:
        d = torch.cat(self.coord_gaps) if self.coord_gaps else torch.zeros(0)
        return {"score_gap": self.score, "loc_gap": self.loc,
                "coord_px": d.median().item() if d.numel() else 0.0,
                "coord_px_max": d.max().item() if d.numel() else 0.0,
                "joints": self.joints, "clear_joints": self.clear}


def _clear(ref: torch.Tensor, rng: torch.Tensor):
    """(B, K) bool: the reference peak exceeds every other pixel of its
    map by CLEAR_MARGIN x the range."""
    B, K, H, W = ref.shape
    flat = ref.reshape(B, K, H * W)
    top, idx = flat.max(-1)
    rest = flat.scatter(-1, idx[..., None], -float("inf"))
    return top - rest.amax(-1) > CLEAR_MARGIN * rng


def compare(ref, coords, scores, centers, scales, hm_hw, acc=None):
    """Fold one batch into the running gaps. ref (B, K, H, W) reference
    heatmaps; coords (B, K, 2) served source coordinates; scores (B, K);
    centers, scales (B, 2)."""
    acc = acc or Gaps()
    ref = ref.float()
    top = ref.amax(dim=(2, 3))
    rng = (top - ref.amin(dim=(2, 3))).clamp_min(1e-12)
    acc.score = max(acc.score, ((scores.float() - top).abs() / rng)
                    .max().item())
    at = R.from_source(coords.float(), centers, scales, hm_hw)
    sentinel = (at < -0.5).any(-1)
    val = R.best_around(ref, at)
    loc = torch.where(sentinel, top.clamp_min(0.0), top - val) / rng
    acc.loc = max(acc.loc, loc.max().item())
    rc, _, posed = R.dark_decode(ref, with_posed=True)
    clear = _clear(ref, rng) & posed & (top > 0) & ~sentinel
    acc.coord_gaps.append((at - rc).norm(dim=-1)[clear])
    acc.joints += top.numel()
    acc.clear += int(clear.sum().item())
    return acc
