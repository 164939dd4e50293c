// Fused DARK heatmap decode for Hopper: per map, argmax of the raw map
// (first index in row-major order on ties), then one Newton step on the
// log of the Gaussian-blurred map (separable zero-padded blur, `ks` taps,
// sigma) at the peak. Border peaks keep the raw argmax; maps whose max is
// not > 0 give (-1, -1). Scores are the raw maxima.
//
// Replaces the TPU kernel tpupose/ops/pallas_decode.py `_decode_kernel`
// (called by `dark_decode_pallas`). The TPU kernel blurs whole tiles of
// maps with masked rolls and reads the peak's neighbourhood out with
// one-hot contractions because gathers do not vectorise there. Here the
// blur is needed only at the 3x3 neighbourhood of the peak, so it is
// evaluated at those 9 points and nowhere else. DARK's amplitude
// renormalisation is a constant shift under the log and cancels in every
// derivative, so it is dropped, as in the TPU kernel.
//
// What bounds it on the H100: each map is read once (12 KB for 64x48) and
// the work per byte is a compare, so memory bandwidth bounds it.
// Design: one warp per map; coalesced 128-byte loads for the argmax, a
// warp-shuffle reduction with the first-index tie-break, then 9 lanes
// each evaluate one blurred point (121 taps, L1/L2 hits) and lane 0 does
// the 2x2 solve.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAX_TAPS = 31;

__global__ void __launch_bounds__(WARPS * 32)
dark_decode_kernel(const float* __restrict__ hm, float* __restrict__ coords,
                   float* __restrict__ scores, int n_maps, int H, int W,
                   int ks, float sigma) {
  __shared__ float taps[32];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const int half = ks / 2;
    const float d = (float)(lane - half);
    const float t = lane < ks ? expf(-(d * d) / (2.f * sigma * sigma)) : 0.f;
    float sum = t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    taps[lane] = t / sum;
  }
  __syncthreads();

  const int map = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (map >= n_maps) return;
  const int HW = H * W;
  const float* m = hm + (size_t)map * HW;

  float best = -INFINITY;
  int bi = HW;
  for (int i = lane; i < HW; i += 32) {
    const float v = m[i];
    if (v > best) { best = v; bi = i; }   // per lane: first index wins
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
  const float mx = best;
  const int px = bi % W, py = bi / W;
  float cx = (float)px, cy = (float)py;

  const bool inner = px >= 1 && px <= W - 2 && py >= 1 && py <= H - 2;
  if (mx > 0.f && inner) {          // uniform across the warp
    const int half = ks / 2;
    float val = 0.f;
    if (lane < 9) {
      const int y = py + lane / 3 - 1, x = px + lane % 3 - 1;
      for (int i = 0; i < ks; ++i) {
        const int yy = y + i - half;
        if (yy < 0 || yy >= H) continue;
        float rs = 0.f;
        for (int j = 0; j < ks; ++j) {
          const int xx = x + j - half;
          if (xx >= 0 && xx < W) rs = fmaf(taps[j], m[yy * W + xx], rs);
        }
        val = fmaf(taps[i], rs, val);
      }
      val = logf(fmaxf(val, 1e-10f));
    }
    // l(dx, dy) lives in lane (dy + 1) * 3 + (dx + 1)
    float l[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) l[k] = __shfl_sync(0xffffffffu, val, k);
    const float c0 = l[4];
    const float dx = 0.5f * (l[5] - l[3]);
    const float dy = 0.5f * (l[7] - l[1]);
    const float dxx = l[5] - 2.f * c0 + l[3];
    const float dyy = l[7] - 2.f * c0 + l[1];
    const float dxy = 0.25f * (l[8] - l[2] - l[6] + l[0]);
    const float det = dxx * dyy - dxy * dxy;
    if (fabsf(det) > 1e-12f) {
      cx += fminf(fmaxf(-(dyy * dx - dxy * dy) / det, -1.f), 1.f);
      cy += fminf(fmaxf(-(dxx * dy - dxy * dx) / det, -1.f), 1.f);
    }
  }
  if (lane == 0) {
    const bool valid = mx > 0.f;
    coords[2 * map] = valid ? cx : -1.f;
    coords[2 * map + 1] = valid ? cy : -1.f;
    scores[map] = mx;
  }
}

}  // namespace

// hm (n_maps, H, W) float32 contiguous -> coords (n_maps, 2) xy float32,
// scores (n_maps,) float32. ks odd, at most 31.
extern "C" int tp_dark_decode(const void* hm, void* coords, void* scores,
                              int n_maps, int H, int W, int ks, float sigma,
                              void* stream) {
  if (ks % 2 != 1 || ks > MAX_TAPS || n_maps <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n_maps + WARPS - 1) / WARPS);
  dark_decode_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<float*>(coords),
      static_cast<float*>(scores), n_maps, H, W, ks, sigma);
  return (int)cudaGetLastError();
}
