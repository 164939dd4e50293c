// Batched bilinear affine warp for Hopper: out[n, yo, xo, c] samples
// frame n / D of the source at (sx, sy) = M_n @ (xo, yo, 1), bilinear,
// zero fill outside [0, Ws-1] x [0, Hs-1]. Source NHWC uint8 or float32,
// output NHWC float32. D = 1 is the train step's augmentation warp; D > 1
// cuts D crops out of every frame without copying the frames.
//
// Replaces the TPU kernel tpupose/ops/pallas_warp.py `_warp_kernel`
// (called by `pallas_affine_warp` and `pallas_crops_from_frames`). The
// TPU has no vector gather, so that kernel rewrites bilinear sampling as
// dense hat-weight matmuls over every source row and column:
// 2*Ho*Wo*Hs*Ws*C FLOPs, ~0.9 TFLOP for a (64, 256, 192, 3) batch, on a
// planar copy of the source. Hopper gathers natively, so none of that is
// carried over: each output pixel reads its four taps and nothing else.
//
// What bounds it on the H100: bytes. At B=128, 256x192x3, the work is
// ~30 FLOPs per output pixel (0.2 GFLOP) against 18.9 MB of uint8 read
// and 75.5 MB of float32 written, ~28 us at 3.35 TB/s. Design: one thread
// per output pixel, all C channels, threads in row-major output order, so
// a warp's stores cover one contiguous run of 32*C floats (coalesced).
// The grid's y index is the output image, so a thread finds its pixel
// with one 32-bit division (no 64-bit index arithmetic).
// The source batch (18.9 MB) fits the 50 MB L2, which serves the taps'
// reuse between neighbouring pixels; taps are read through the read-only
// path (__ldg). The uint8 -> float32 cast is fused into the read; there
// is no planar transpose and no scratch.
//
// Numerics: sx, sy and the blend are computed in the order of the plain
// version (tpupose_torch/ops/affine.batched_affine_warp) with
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts nothing into an
// FMA and every output equals the plain version's on the card.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_px(const uint8_t* p) {
  return (float)__ldg(p);
}
__device__ __forceinline__ float load_px(const float* p) { return __ldg(p); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const T* __restrict__ src, const float* __restrict__ mats,
            float* __restrict__ out, int n_out, int Hs, int Ws, int C,
            int Ho, int Wo, int D) {
  const int p = blockIdx.x * THREADS + threadIdx.x;   // pixel in image n
  const int n = blockIdx.y;
  if (p >= Ho * Wo) return;
  const int yo = p / Wo;
  const int xo = p - yo * Wo;

  const float* m = mats + 6 * n;
  const float fx = (float)xo, fy = (float)yo;
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 0), fx),
                                       __fmul_rn(__ldg(m + 1), fy)),
                             __ldg(m + 2));
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 3), fx),
                                       __fmul_rn(__ldg(m + 4), fy)),
                             __ldg(m + 5));
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0);
  const float owx = __fsub_rn(1.f, wx), owy = __fsub_rn(1.f, wy);

  const float xmax = (float)(Ws - 1), ymax = (float)(Hs - 1);
  const bool vx0 = x0 >= 0.f && x0 <= xmax, vx1 = x1 >= 0.f && x1 <= xmax;
  const bool vy0 = y0 >= 0.f && y0 <= ymax, vy1 = y1 >= 0.f && y1 <= ymax;
  // clamped indices (only read where valid; the clamp keeps them in range)
  const int ix0 = (int)fminf(fmaxf(x0, 0.f), xmax);
  const int ix1 = (int)fminf(fmaxf(x1, 0.f), xmax);
  const int iy0 = (int)fminf(fmaxf(y0, 0.f), ymax);
  const int iy1 = (int)fminf(fmaxf(y1, 0.f), ymax);

  const T* img = src + (size_t)(n / D) * Hs * Ws * C;
  const T* p00 = img + ((size_t)iy0 * Ws + ix0) * C;
  const T* p01 = img + ((size_t)iy0 * Ws + ix1) * C;
  const T* p10 = img + ((size_t)iy1 * Ws + ix0) * C;
  const T* p11 = img + ((size_t)iy1 * Ws + ix1) * C;
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  float* o = out + ((size_t)n * Ho * Wo + p) * C;
  for (int c = 0; c < C; ++c) {
    const float a = v00 ? load_px(p00 + c) : 0.f;
    const float b = v01 ? load_px(p01 + c) : 0.f;
    const float d = v10 ? load_px(p10 + c) : 0.f;
    const float e = v11 ? load_px(p11 + c) : 0.f;
    const float top = __fadd_rn(__fmul_rn(a, owx), __fmul_rn(b, wx));
    const float bot = __fadd_rn(__fmul_rn(d, owx), __fmul_rn(e, wx));
    o[c] = __fadd_rn(__fmul_rn(top, owy), __fmul_rn(bot, wy));
  }
}

}  // namespace

// src (n_out / D, Hs, Ws, C) contiguous, uint8 (src_is_u8 = 1) or float32;
// mats (n_out, 2, 3) float32 contiguous dst->src; out (n_out, Ho, Wo, C)
// float32 contiguous. Crop n reads frame n / D.
extern "C" int tp_affine_warp(const void* src, const void* mats, void* out,
                              int src_is_u8, int n_out, int Hs, int Ws, int C,
                              int Ho, int Wo, int D, void* stream) {
  if (n_out <= 0 || Hs <= 0 || Ws <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 ||
      D <= 0 || n_out % D != 0 || n_out > 65535 ||
      (long long)Ho * Wo > 0x7fffffffLL - THREADS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Ho * Wo + THREADS - 1) / THREADS),
                  (unsigned)n_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mats);
  float* o = static_cast<float*>(out);
  if (src_is_u8) {
    warp_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(src), m, o, n_out, Hs, Ws, C, Ho, Wo, D);
  } else {
    warp_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(src), m, o, n_out, Hs, Ws, C, Ho, Wo, D);
  }
  return (int)cudaGetLastError();
}
