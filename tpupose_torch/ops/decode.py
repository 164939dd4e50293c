"""Heatmap decoding: argmax + quarter-offset / DARK, flip-test merging
(counterpart of tpupose/ops/decode.py).

DARK (arXiv:1910.06278): blur the heatmap, take its log, and take one
Newton step at the argmax using the local gradient and Hessian.
`decode_heatmaps(method="dark")` sends a CUDA tensor to the fused
hand-written kernel (tpupose_torch/ops/cuda_decode.py); a CPU tensor
takes the plain path below.
"""

from __future__ import annotations

import torch


def get_max_preds(heatmaps: torch.Tensor):
    """Argmax decode. (B, K, H, W) -> coords (B, K, 2) xy float32,
    maxvals (B, K). Ties go to the first index in row-major order;
    zero-confidence maps (max <= 0) give (-1, -1)."""
    B, K, H, W = heatmaps.shape
    flat = heatmaps.reshape(B, K, H * W)
    maxvals, idx = flat.max(dim=-1)
    # torch.max's index on ties is not documented as the first one;
    # recover it explicitly (jnp.argmax returns the first)
    n = torch.arange(H * W, device=flat.device)
    idx = torch.where(flat == maxvals[..., None], n, H * W).amin(dim=-1)
    x = (idx % W).to(torch.float32)
    y = (idx // W).to(torch.float32)
    coords = torch.stack([x, y], dim=-1)
    coords = torch.where((maxvals > 0.0)[..., None], coords,
                         torch.full_like(coords, -1.0))
    return coords, maxvals


def _gather_hm(heatmaps, xi, yi):
    """heatmaps (B, K, H, W); xi, yi int64 (B, K) -> values, clamped."""
    B, K, H, W = heatmaps.shape
    xi = xi.clamp(0, W - 1)
    yi = yi.clamp(0, H - 1)
    flat = heatmaps.reshape(B, K, H * W)
    return torch.gather(flat, -1, (yi * W + xi)[..., None])[..., 0]


def quarter_offset_refine(heatmaps, coords):
    """Classic MSRA +/-0.25 px shift toward the higher neighbour; border
    peaks stay unshifted."""
    xi = coords[..., 0].to(torch.int64)
    yi = coords[..., 1].to(torch.int64)
    dx = _gather_hm(heatmaps, xi + 1, yi) - _gather_hm(heatmaps, xi - 1, yi)
    dy = _gather_hm(heatmaps, xi, yi + 1) - _gather_hm(heatmaps, xi, yi - 1)
    off = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    H, W = heatmaps.shape[2], heatmaps.shape[3]
    inner = ((coords[..., 0] > 0) & (coords[..., 0] < W - 1)
             & (coords[..., 1] > 0) & (coords[..., 1] < H - 1))
    return coords + off * inner[..., None]


def gaussian_taps(kernel_size: int = 11, sigma: float = 2.0,
                  device=None) -> torch.Tensor:
    """Normalised 1-D Gaussian taps, float32."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    half = kernel_size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return k / k.sum()


def _band_matrix(n: int, taps: torch.Tensor) -> torch.Tensor:
    """(n, n) banded matrix of a zero-padded 1-D convolution:
    out[i] = sum_j taps[j] * x[i + j - half]."""
    half = taps.shape[0] // 2
    i = torch.arange(n, device=taps.device)
    d = i[None, :] - i[:, None] + half              # tap index of (row, col)
    valid = (d >= 0) & (d < taps.shape[0])
    return torch.where(valid, taps[d.clamp(0, taps.shape[0] - 1)],
                       torch.zeros((), device=taps.device))


def gaussian_blur(heatmaps, kernel_size: int = 11, sigma: float = 2.0,
                  renormalize: bool = True):
    """Separable zero-padded Gaussian blur of (B, K, H, W) maps, as two
    banded matrix products in float32. With `renormalize` each map is
    rescaled to keep its peak amplitude (DARK's modulation)."""
    B, K, H, W = heatmaps.shape
    k = gaussian_taps(kernel_size, sigma, heatmaps.device)
    hm = heatmaps.to(torch.float32)
    x = torch.einsum("hH,bkHw->bkhw", _band_matrix(H, k), hm)
    x = torch.einsum("bkhW,wW->bkhw", x, _band_matrix(W, k))
    if renormalize:
        orig_max = hm.reshape(B, K, -1).amax(-1)
        new_max = x.reshape(B, K, -1).amax(-1)
        x = x * (orig_max / new_max.clamp_min(1e-10))[..., None, None]
    return x.to(heatmaps.dtype)


def dark_refine(heatmaps, coords, blur_kernel: int = 11, sigma: float = 2.0,
                renormalize: bool = True):
    """DARK Taylor-expansion sub-pixel refinement at the argmax: one Newton
    step on log(blurred heatmap), the 2x2 Hessian solved in closed form.
    Border peaks keep the raw argmax."""
    hm = gaussian_blur(heatmaps, blur_kernel, sigma, renormalize)
    hm = torch.log(hm.clamp_min(1e-10))
    xi = coords[..., 0].to(torch.int64)
    yi = coords[..., 1].to(torch.int64)

    def v(dx, dy):
        return _gather_hm(hm, xi + dx, yi + dy)

    c0 = v(0, 0)
    dx = 0.5 * (v(1, 0) - v(-1, 0))
    dy = 0.5 * (v(0, 1) - v(0, -1))
    dxx = v(1, 0) - 2.0 * c0 + v(-1, 0)
    dyy = v(0, 1) - 2.0 * c0 + v(0, -1)
    dxy = 0.25 * (v(1, 1) - v(1, -1) - v(-1, 1) + v(-1, -1))

    det = dxx * dyy - dxy * dxy
    ok = det.abs() > 1e-12
    det = torch.where(ok, det, torch.ones_like(det))
    ox = -(dyy * dx - dxy * dy) / det
    oy = -(dxx * dy - dxy * dx) / det
    off = torch.stack([ox, oy], dim=-1)
    off = torch.where(ok[..., None], off, torch.zeros_like(off))
    off = off.clamp(-1.0, 1.0)

    H, W = heatmaps.shape[2], heatmaps.shape[3]
    inner = ((coords[..., 0] >= 1) & (coords[..., 0] <= W - 2)
             & (coords[..., 1] >= 1) & (coords[..., 1] <= H - 2))
    return coords + off * inner[..., None]


def decode_heatmaps(heatmaps, method: str = "dark", blur_kernel: int = 11,
                    sigma: float = 2.0):
    """(B, K, H, W) -> coords (B, K, 2) in heatmap px, scores (B, K).
    method "dark" on a CUDA tensor runs the fused decode kernel."""
    if method == "dark" and heatmaps.is_cuda:
        from tpupose_torch.ops.cuda_decode import dark_decode

        return dark_decode(heatmaps, blur_kernel, sigma)
    coords, maxvals = get_max_preds(heatmaps)
    if method == "dark":
        coords = dark_refine(heatmaps, coords, blur_kernel, sigma)
    elif method == "quarter_offset":
        coords = quarter_offset_refine(heatmaps, coords)
    elif method != "argmax":
        raise ValueError(f"unknown decode method {method!r}")
    return coords, maxvals


def flip_back(flipped_heatmaps, flip_pairs, shift: bool = True):
    """Un-flip (B, K, H, W) heatmaps of a horizontally flipped forward:
    reverse the width axis, swap left/right channels (flip_pairs (P, 2)),
    and with `shift` apply the classic 1-px right shift."""
    hm = flipped_heatmaps.flip(-1)
    perm = list(range(hm.shape[1]))
    for a, b in (tuple(int(v) for v in p) for p in flip_pairs):
        perm[a], perm[b] = b, a
    hm = hm[:, perm]
    if shift:
        hm = torch.cat([hm[..., :1], hm[..., :-1]], dim=-1)
    return hm


def merge_flip(heatmaps, flipped_heatmaps, flip_pairs, shift: bool = True):
    """Flip-test averaging; shift=False under UDP, where the axis reversal
    is already the exact mirror."""
    return 0.5 * (heatmaps + flip_back(flipped_heatmaps, flip_pairs,
                                       shift=shift))
