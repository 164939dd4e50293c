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


def _first_argmax(p):
    """Index of the first maximum along the last axis (jnp.argmax's tie
    rule; torch.max does not document which index it returns on ties)."""
    n = p.shape[-1]
    idx = torch.arange(n, device=p.device)
    return torch.where(p == p.amax(-1, keepdim=True), idx, n).amin(-1)


def get_max_preds(heatmaps: torch.Tensor):
    """Argmax decode. (B, K, H, W) -> coords (B, K, 2) xy float32,
    maxvals (B, K). Ties go to the first index in row-major order;
    zero-confidence maps (max <= 0) give (-1, -1)."""
    B, K, H, W = heatmaps.shape
    flat = heatmaps.reshape(B, K, H * W)
    maxvals, idx = flat.amax(dim=-1), _first_argmax(flat)
    x = (idx % W).to(torch.float32)
    y = (idx // W).to(torch.float32)
    coords = torch.stack([x, y], dim=-1)
    coords = torch.where((maxvals > 0.0)[..., None], coords,
                         torch.full_like(coords, -1.0))
    return coords, maxvals


def _gather_hm(heatmaps, xi, yi):
    """heatmaps (B, K, H, W); xi, yi int64 (B, K) or (B, K, P) (bottom-up
    candidates, gathered along the flattened map) -> values, clamped."""
    B, K, H, W = heatmaps.shape
    xi = xi.clamp(0, W - 1)
    yi = yi.clamp(0, H - 1)
    flat = heatmaps.reshape(B, K, H * W)
    idx = yi * W + xi
    if idx.dim() == flat.dim() - 1:
        return torch.gather(flat, -1, idx[..., None])[..., 0]
    return torch.gather(flat, -1, idx)


def quarter_offset_refine(heatmaps, coords):
    """Classic MSRA +/-0.25 px shift toward the higher neighbour; border
    peaks stay unshifted. coords (B, K, 2), or (B, K, P, 2) for the
    bottom-up candidates (ops/ae_decode.py)."""
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


# ---------------------------------------------------------------------------
# SimCC (1D coordinate classification) decode: models/simcc.py
# ---------------------------------------------------------------------------

def _parabolic_1d(logp, idx):
    """3-point parabolic sub-bin refinement on log-probabilities: logp
    (..., N), idx (...) the argmax -> offset in [-0.5, 0.5], the vertex of
    the parabola through idx-1, idx, idx+1; 0 at the borders."""
    n = logp.shape[-1]
    i0 = (idx - 1).clamp(0, n - 1)
    i2 = (idx + 1).clamp(0, n - 1)
    f0 = torch.gather(logp, -1, i0[..., None])[..., 0]
    f1 = torch.gather(logp, -1, idx[..., None])[..., 0]
    f2 = torch.gather(logp, -1, i2[..., None])[..., 0]
    denom = f0 - 2.0 * f1 + f2
    ok = denom.abs() > 1e-9
    off = torch.where(ok, 0.5 * (f0 - f2)
                      / torch.where(ok, denom, torch.ones_like(denom)),
                      torch.zeros_like(denom))
    off = off.clamp(-0.5, 0.5)
    interior = (idx > 0) & (idx < n - 1)
    return torch.where(interior, off, torch.zeros_like(off))


def decode_simcc(x_logits, y_logits, refine: bool = True):
    """Per-axis softmax -> argmax (+ parabolic sub-bin) -> coords in BIN
    units; score sqrt(px * py) of the two axis peaks. x_logits (B, K,
    Wb), y_logits (B, K, Hb) -> coords (B, K, 2) (x, y), scores (B, K)."""
    px = torch.softmax(x_logits.float(), -1)
    py = torch.softmax(y_logits.float(), -1)
    xi, yi = _first_argmax(px), _first_argmax(py)
    x, y = xi.float(), yi.float()
    if refine:
        x = x + _parabolic_1d(torch.log(px.clamp_min(1e-12)), xi)
        y = y + _parabolic_1d(torch.log(py.clamp_min(1e-12)), yi)
    sx = torch.gather(px, -1, xi[..., None])[..., 0]
    sy = torch.gather(py, -1, yi[..., None])[..., 0]
    return torch.stack([x, y], -1), torch.sqrt(sx * sy)


def simcc_flip_back(x_logits_f, y_logits_f, flip_pairs, shift_bins: int = 0):
    """Un-flip SimCC logits of a horizontally flipped forward: reverse the
    x-bin axis, shift it left by `shift_bins` (edge-padded; round(r) - 1
    for split ratio r cancels the mirror's bias exactly, 0 under udp), and
    swap the left/right keypoint channels of both axes."""
    xl = x_logits_f.flip(-1)
    if shift_bins > 0:
        pad = xl[..., -1:].expand(*xl.shape[:-1], shift_bins)
        xl = torch.cat([xl[..., shift_bins:], pad], dim=-1)
    perm = list(range(xl.shape[1]))
    for a, b in (tuple(int(v) for v in p) for p in flip_pairs):
        perm[a], perm[b] = b, a
    return xl[:, perm], y_logits_f[:, perm]
