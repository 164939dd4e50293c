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
// and 75.5 MB of float32 written, ~28 us at 3.35 TB/s; on the card a
// plain uint8 -> float32 cast of the same batch (the same bytes, no
// gather) takes ~56 us, a fill of the output alone ~24 us
// (scripts/k1k7_ab.py). PR 3's design (a thread a pixel, 12 single-byte
// gathers from device memory, three scalar stores at a 12-byte stride)
// took ~87 us: a warp's gathers along a rotated line of the source touched
// up to ~30 cache lines each, its stores wrote 384-byte spans for 128
// useful bytes, and every cast (the bytes, the coordinates, the indices)
// ran on the conversion pipe, 16 lanes a clock per SM.
//
// Design: a block owns a TW x TH tile of one output image (64 x 32).
//   - Taps from shared memory. The block first stages the tile's source
//     footprint there with 16-byte cp.async copies (a warp a row): the
//     bounding box of the taps of the tile's four corners (sx and sy are
//     monotone in xo and in yo, since every rounding step is, so the
//     corners bound the tile), clipped to the image, widened to 16-byte
//     boundaries. The gathers then read shared memory, where a rotated
//     line spreads over banks rather than cache lines.
//   - A tile whose footprint does not fit the FOOT-byte buffer (a zoom-out
//     by ~1.7x or more at 60 degrees), or whose source rows are not
//     16-byte aligned, or whose corners map to no finite position, gathers
//     its taps from device memory through the read-only path instead, in
//     the same kernel; `gathered`, where given, counts such tiles.
//   - 16-byte stores. A warp computes 32 consecutive pixels of an output
//     row (a lane each), stages their C <= 4 channels in shared memory
//     (32 C floats, contiguous in NHWC) and writes them as 8 C float4
//     stores of consecutive addresses, marked streaming (evict first) so
//     that the output does not push the source out of L2: a 384-byte run
//     of the output for C = 3. A segment cut by the image's right edge,
//     or one that starts off a 16-byte boundary (Wo * C not a multiple of
//     4), or wider pixels (C > 4, four channels a pass), are written a
//     float at a time from the same staging.
//   - No conversion instruction per tap: bytes, coordinates and indices
//     are converted exactly on the FP32 pipe (exact_float, exact_int).
// The uint8 -> float32 cast is fused into the gather; there is no planar
// transpose and no scratch in device memory. TW, TH, FOOT and the
// occupancy ptxas fits the registers to (MINB blocks an SM) can be set
// with -DK7_TW, -DK7_TH, -DK7_FOOT, -DK7_MINB; scripts/k1k7_ab.py builds
// such settings beside the default to time them (FOOT = 0: every tile
// gathers from device memory).
//
// Numerics: sx, sy and the blend are computed in the order of the plain
// version (tpupose_torch/ops/affine.batched_affine_warp) with
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts nothing into an
// FMA and every output equals the plain version's on the card, on either
// path.
#include <math.h>

#include <type_traits>

#include "common.cuh"

#ifndef K7_TW
#define K7_TW 64                 // a block's output tile, K7_TW x K7_TH pixels
#endif
#ifndef K7_TH
#define K7_TH 32
#endif
#ifndef K7_FOOT
#define K7_FOOT 40960            // bytes of staged source footprint a block
#endif
#ifndef K7_MINB
#define K7_MINB 4                // blocks an SM that ptxas fits the uint8 build's
#endif                           // registers to (the float32 build would spill)

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int TW = K7_TW, TH = K7_TH, FOOT = K7_FOOT;
constexpr int SEGS_X = TW / 32;           // 32-pixel row segments of a tile row
constexpr int SEGS = SEGS_X * TH;
constexpr int CH = 4;                     // channels a pass through the staging
constexpr int SMEM = FOOT + WARPS * 32 * CH * 4;
static_assert(TW % 32 == 0 && TH > 0 && FOOT >= 0 && FOOT % 16 == 0, "tile");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Exact conversions on the FP32 pipe: the float of an integer 0 <= v < 2^23,
// and the int of an integral float 0 <= f < 2^23 (cvt runs on a pipe of 16
// lanes a clock per SM, an eighth of the FP32 pipe's rate).
__device__ __forceinline__ float exact_float(unsigned v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f);
}
__device__ __forceinline__ int exact_int(float f) {
  return __float_as_int(__fadd_rn(f, 8388608.f)) - 0x4B000000;
}
__device__ __forceinline__ float tap_value(uint8_t v) { return exact_float(v); }
__device__ __forceinline__ float tap_value(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 1 ? K7_MINB : 1)
warp_kernel(const T* __restrict__ src, const float* __restrict__ mats, float* __restrict__ out,
            int Hs, int Ws, int C, int Ho, int Wo, int D, int tiles_x, int tiles_img,
            int can_stage, unsigned* __restrict__ gathered) {
  extern __shared__ __align__(16) unsigned char foot[];
  float* st = reinterpret_cast<float*>(foot + FOOT) + (threadIdx.x >> 5) * 32 * CH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x / tiles_img, tile = blockIdx.x - n * tiles_img;
  const int tx0 = (tile % tiles_x) * TW, ty0 = (tile / tiles_x) * TH;
  const int tx1 = min(tx0 + TW, Wo) - 1, ty1 = min(ty0 + TH, Ho) - 1;

  const float* m = mats + 6 * n;
  const float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
  const float m3 = __ldg(m + 3), m4 = __ldg(m + 4), m5 = __ldg(m + 5);
  // source x and y of output pixel (fx, fy), in the plain version's order
  auto map = [&](float fx, float fy, float& sx, float& sy) {
    sx = __fadd_rn(__fadd_rn(__fmul_rn(m0, fx), __fmul_rn(m1, fy)), m2);
    sy = __fadd_rn(__fadd_rn(__fmul_rn(m3, fx), __fmul_rn(m4, fy)), m5);
  };
  const float xmax = (float)(Ws - 1), ymax = (float)(Hs - 1);
  const int px_b = C * (int)sizeof(T), row_b = Ws * px_b;      // bytes of a pixel, a row
  const T* img = src + (size_t)(n / D) * Hs * Ws * C;

  // the footprint: taps floor(s) and floor(s) + 1 over the range of the
  // corners' s, clipped to the image (every thread computes the same, so
  // `staged` is uniform over the block)
  float lx = INFINITY, hx = -INFINITY, ly = INFINITY, hy = -INFINITY;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float sx, sy;
    map((float)(k & 1 ? tx1 : tx0), (float)(k & 2 ? ty1 : ty0), sx, sy);
    finite = finite && isfinite(sx) && isfinite(sy);
    lx = fminf(lx, sx), hx = fmaxf(hx, sx), ly = fminf(ly, sy), hy = fmaxf(hy, sy);
  }
  const float fx0 = fmaxf(floorf(lx), 0.f), fx1 = fminf(floorf(hx) + 1.f, xmax);
  const float fy0 = fmaxf(floorf(ly), 0.f), fy1 = fminf(floorf(hy) + 1.f, ymax);
  bool staged = FOOT > 0 && can_stage && finite;
  int y0 = 0, rows = 0, a0 = 0, pitch = 0;   // first row, rows, first byte of a row, bytes a row
  if (staged && fx0 <= fx1 && fy0 <= fy1) {  // else no tap falls in the image
    y0 = (int)fy0;
    rows = (int)fy1 - y0 + 1;
    a0 = ((int)fx0 * px_b) & ~15;
    pitch = ((((int)fx1 + 1) * px_b + 15) & ~15) - a0;
    staged = (long long)rows * pitch <= FOOT;
  }
  if (!staged) {
    if (threadIdx.x == 0 && gathered) atomicAdd(gathered, 1u);
  } else if (rows) {
    const unsigned char* g = reinterpret_cast<const unsigned char*>(img) + (size_t)y0 * row_b + a0;
    for (int r = warp; r < rows; r += WARPS)         // a warp a row, a lane 16 bytes
      for (int k = 16 * lane; k < pitch; k += 512)
        cp_async16(foot + r * pitch + k, g + (size_t)r * row_b + k);
    cp_async_wait_all();
  }
  __syncthreads();

  const float flane = exact_float(lane);
  auto segments = [&](auto from_shared) {
    constexpr bool SH = decltype(from_shared)::value;
    for (int s = warp; s < SEGS; s += WARPS) {
      const int yo = ty0 + s / SEGS_X, xs = tx0 + 32 * (s % SEGS_X);
      if (yo > ty1 || xs > tx1) continue;            // uniform over the warp
      float sx, sy;
      map(__fadd_rn(exact_float(xs), flane), exact_float(yo), sx, sy);
      const float x0 = floorf(sx), y0f = floorf(sy);
      const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0f, 1.f);
      const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0f);
      const float owx = __fsub_rn(1.f, wx), owy = __fsub_rn(1.f, wy);
      const bool in = xs + lane <= tx1;
      const bool vx0 = x0 >= 0.f && x0 <= xmax, vx1 = x1 >= 0.f && x1 <= xmax;
      const bool vy0 = in && y0f >= 0.f && y0f <= ymax, vy1 = in && y1 >= 0.f && y1 <= ymax;
      const bool v00 = vy0 && vx0, v01 = vy0 && vx1, v10 = vy1 && vx0, v11 = vy1 && vx1;
      // clamped indices (read only where valid; the clamp keeps them in range)
      const int ix0 = exact_int(fminf(fmaxf(x0, 0.f), xmax));
      const int ix1 = exact_int(fminf(fmaxf(x1, 0.f), xmax));
      const int iy0 = exact_int(fminf(fmaxf(y0f, 0.f), ymax));
      const int iy1 = exact_int(fminf(fmaxf(y1, 0.f), ymax));
      // tap offsets: bytes into the footprint, or elements into the image
      std::conditional_t<SH, int, size_t> o00, o01, o10, o11;
      if constexpr (SH) {
        const int r0 = (iy0 - y0) * pitch - a0, r1 = (iy1 - y0) * pitch - a0;
        o00 = r0 + ix0 * px_b, o01 = r0 + ix1 * px_b, o10 = r1 + ix0 * px_b, o11 = r1 + ix1 * px_b;
      } else {
        o00 = ((size_t)iy0 * Ws + ix0) * C, o01 = ((size_t)iy0 * Ws + ix1) * C;
        o10 = ((size_t)iy1 * Ws + ix0) * C, o11 = ((size_t)iy1 * Ws + ix1) * C;
      }
      auto tap = [&](bool v, decltype(o00) o, int c) -> float {
        if (!v) return 0.f;
        if constexpr (SH)
          return tap_value(*reinterpret_cast<const T*>(foot + o + c * (int)sizeof(T)));
        else
          return tap_value(__ldg(img + o + c));
      };
      float* dst = out + (((size_t)n * Ho + yo) * Wo + xs) * C;
      for (int c0 = 0; c0 < C; c0 += CH) {
        const int cc = min(CH, C - c0);
        for (int c = 0; c < cc; ++c) {
          const float ta = tap(v00, o00, c0 + c), tb = tap(v01, o01, c0 + c);
          const float td = tap(v10, o10, c0 + c), te = tap(v11, o11, c0 + c);
          const float top = __fadd_rn(__fmul_rn(ta, owx), __fmul_rn(tb, wx));
          const float bot = __fadd_rn(__fmul_rn(td, owx), __fmul_rn(te, wx));
          st[lane * cc + c] = __fadd_rn(__fmul_rn(top, owy), __fmul_rn(bot, wy));
        }
        __syncwarp();
        if (C <= CH && xs + 31 <= tx1 && !(reinterpret_cast<uintptr_t>(dst) & 15)) {
          if (lane < 8 * C)
            __stcs(reinterpret_cast<float4*>(dst) + lane, reinterpret_cast<const float4*>(st)[lane]);
        } else {
          for (int i = lane; i < 32 * cc; i += 32) {
            const int p = i / cc;
            if (xs + p <= tx1) dst[p * C + c0 + i - p * cc] = st[i];
          }
        }
        __syncwarp();
      }
    }
  };
  if (staged)
    segments(std::true_type{});
  else
    segments(std::false_type{});
}

template <typename T>
int launch(const void* src, const float* mats, float* out, int Hs, int Ws, int C, int Ho, int Wo,
           int D, int tiles_x, int tiles_img, int total, unsigned* gathered, cudaStream_t stream) {
  static int cache[TP_MAX_DEVICES];
  auto kernel = warp_kernel<T>;
  int resident = 0;                        // sets the shared memory limit once a device
  const cudaError_t e = resident_blocks(kernel, THREADS, SMEM, cache, &resident);
  if (e != cudaSuccess) return (int)e;
  const int can_stage = reinterpret_cast<uintptr_t>(src) % 16 == 0 && (long long)Ws * C * sizeof(T) % 16 == 0;
  kernel<<<total, THREADS, SMEM, stream>>>(static_cast<const T*>(src), mats, out, Hs, Ws, C, Ho,
                                           Wo, D, tiles_x, tiles_img, can_stage, gathered);
  return (int)cudaGetLastError();
}

}  // namespace

// src (n_out / D, Hs, Ws, C) contiguous, uint8 (src_is_u8 = 1) or float32;
// mats (n_out, 2, 3) float32 contiguous dst->src; out (n_out, Ho, Wo, C)
// float32 contiguous. Crop n reads frame n / D. gathered: null, or an
// unsigned counter on the device to which the kernel adds the tiles that
// gathered their taps from device memory.
extern "C" int tp_affine_warp(const void* src, const void* mats, void* out, int src_is_u8,
                              int n_out, int Hs, int Ws, int C, int Ho, int Wo, int D,
                              void* gathered, void* stream) {
  if (n_out <= 0 || Hs <= 0 || Ws <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || D <= 0 ||
      n_out % D != 0 || Hs >= (1 << 23) || Ws >= (1 << 23) || Ho >= (1 << 23) ||
      Wo >= (1 << 23) || (long long)Ws * C * 4 > 0x7fff0000LL)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (Wo + TW - 1) / TW;
  const long long tiles_img = (long long)tiles_x * ((Ho + TH - 1) / TH);
  if (tiles_img * n_out > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int total = (int)tiles_img * n_out;
  const float* m = static_cast<const float*>(mats);
  float* o = static_cast<float*>(out);
  unsigned* g = static_cast<unsigned*>(gathered);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return src_is_u8
             ? launch<uint8_t>(src, m, o, Hs, Ws, C, Ho, Wo, D, tiles_x, (int)tiles_img, total, g, s)
             : launch<float>(src, m, o, Hs, Ws, C, Ho, Wo, D, tiles_x, (int)tiles_img, total, g, s);
}
